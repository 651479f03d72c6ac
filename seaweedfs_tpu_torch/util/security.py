"""Write-path auth: HMAC-signed JWTs + cookies.

Mirrors weed/security (SURVEY.md §2 "Security"): when a signing key is
configured, the master attaches a short-lived token to each Assign
response (``GenJwt``) and volume servers verify it on writes/deletes
(``Guard``). Tokens are standard JWS compact HS256 — header.payload.sig
with base64url parts — built on hashlib/hmac so no external jwt
dependency is needed. An empty key disables enforcement, matching the
reference's default.

The port's copy of ``seaweedfs_tpu/util/security.py``: a token either
package signs verifies in the other.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets
import time


def new_cookie() -> int:
    """Random 32-bit needle cookie (needle/file_id semantics)."""
    return secrets.randbits(32)


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class Guard:
    """Issues and checks HS256 tokens scoped to one file id."""

    def __init__(self, key: str = "", expires_seconds: int = 10):
        self.key = key.encode() if key else b""
        self.expires_seconds = expires_seconds

    @property
    def enabled(self) -> bool:
        return bool(self.key)

    def sign(self, fid: str) -> str:
        if not self.enabled:
            return ""
        header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        payload = _b64(json.dumps({
            "fid": fid,
            "exp": int(time.time()) + self.expires_seconds}).encode())
        signing_input = f"{header}.{payload}".encode()
        sig = _b64(hmac.new(self.key, signing_input, hashlib.sha256)
                   .digest())
        return f"{header}.{payload}.{sig}"

    def verify(self, token: str, fid: str) -> bool:
        """True iff the token is valid for ``fid`` (or auth is off)."""
        if not self.enabled:
            return True
        try:
            header, payload, sig = token.split(".")
            signing_input = f"{header}.{payload}".encode()
            want = hmac.new(self.key, signing_input, hashlib.sha256).digest()
            if not hmac.compare_digest(want, _unb64(sig)):
                return False
            claims = json.loads(_unb64(payload))
            return (claims.get("fid") == fid
                    and claims.get("exp", 0) >= time.time())
        except (ValueError, KeyError, json.JSONDecodeError):
            return False


class _ClientCallDetails:
    """Minimal grpc.ClientCallDetails carrier for the auth interceptor."""

    __slots__ = ("method", "timeout", "metadata", "credentials",
                 "wait_for_ready", "compression")

    def __init__(self, base, metadata):
        self.method = base.method
        self.timeout = base.timeout
        self.metadata = metadata
        self.credentials = getattr(base, "credentials", None)
        self.wait_for_ready = getattr(base, "wait_for_ready", None)
        self.compression = getattr(base, "compression", None)


def grpc_sign(guard: Guard, ttl: int = 60) -> str:
    """Cluster-internal gRPC bearer token: same HS256 JWS as the write
    path, scoped "grpc" instead of a fid (the reference secures this
    plane with gRPC TLS; an env without cert plumbing uses the shared
    signing key — weed/security's Guard role extended to admin/read
    rpcs per SURVEY.md §2 Security)."""
    if not guard.enabled:
        return ""
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64(json.dumps({
        "scope": "grpc", "exp": int(time.time()) + ttl}).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = _b64(hmac.new(guard.key, signing_input, hashlib.sha256)
               .digest())
    return f"{header}.{payload}.{sig}"


def grpc_verify(guard: Guard, token: str) -> bool:
    if not guard.enabled:
        return True
    try:
        header, payload, sig = token.split(".")
        signing_input = f"{header}.{payload}".encode()
        want = hmac.new(guard.key, signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(want, _unb64(sig)):
            return False
        claims = json.loads(_unb64(payload))
        return (claims.get("scope") == "grpc"
                and claims.get("exp", 0) >= time.time())
    except (ValueError, KeyError, json.JSONDecodeError):
        return False


def grpc_server_interceptor(guard: Guard):
    """Server-side enforcement: every rpc must carry a valid bearer
    token once a key is configured. Returns None when auth is off."""
    import grpc

    if not guard.enabled:
        return None

    def deny(request, context):
        context.abort(grpc.StatusCode.UNAUTHENTICATED,
                      "missing or invalid grpc auth token")

    deny_handler = grpc.unary_unary_rpc_method_handler(deny)

    class _Auth(grpc.ServerInterceptor):
        def intercept_service(self, continuation, details):
            md = dict(details.invocation_metadata or ())
            tok = md.get("authorization", "")
            if tok.startswith("Bearer "):
                tok = tok[len("Bearer "):]
            if grpc_verify(guard, tok):
                return continuation(details)
            return deny_handler

    return _Auth()


def grpc_auth_channel(channel, guard: Guard):
    """Client-side: wrap a channel so every call carries a fresh bearer
    token. No-op when auth is off."""
    import grpc

    if not guard.enabled:
        return channel

    class _Attach(grpc.UnaryUnaryClientInterceptor,
                  grpc.UnaryStreamClientInterceptor,
                  grpc.StreamUnaryClientInterceptor,
                  grpc.StreamStreamClientInterceptor):
        def _details(self, cd):
            md = list(cd.metadata or [])
            md.append(("authorization", f"Bearer {grpc_sign(guard)}"))
            return _ClientCallDetails(cd, md)

        def intercept_unary_unary(self, cont, cd, req):
            return cont(self._details(cd), req)

        def intercept_unary_stream(self, cont, cd, req):
            return cont(self._details(cd), req)

        def intercept_stream_unary(self, cont, cd, it):
            return cont(self._details(cd), it)

        def intercept_stream_stream(self, cont, cd, it):
            return cont(self._details(cd), it)

    return grpc.intercept_channel(channel, _Attach())
