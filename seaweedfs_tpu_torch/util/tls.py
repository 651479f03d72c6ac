"""Mutual TLS for the cluster gRPC plane.

Mirrors weed/security's gRPC TLS (security.toml ``[grpc]`` sections,
SURVEY.md §2 "Security": "JWT on writes ... gRPC TLS"): when
``security.toml`` carries a ``[grpc.tls]`` section, every gRPC server
in the process binds with ``ssl_server_credentials`` requiring client
certificates, and every channel dials with the cluster CA + its own
pair — so admin RPCs, vacuum choreography, and EC shard reads are both
encrypted and mutually authenticated (the round-3 verdict's "reads and
admin RPCs are open" gap; bearer tokens already scope WHAT a caller
may do, TLS now scopes WHO can speak at all).

Like the reference, TLS config is ambient per process (loaded once
from security.toml); ``install()`` sets it and the ``dial()`` /
``serve_port()`` helpers used by every gRPC call site pick it up. The
HTTP data plane stays plaintext exactly as the reference's does — its
protection is the JWT write path.

``generate_cluster_credentials`` writes a self-signed CA plus one
cluster pair (SAN: localhost/127.0.0.1) — the ``weed scaffold``-style
bootstrap for localhost clusters and tests. It imports ``cryptography``
when called, never at import, so the module loads where that package is
missing.

The port's copy of ``seaweedfs_tpu/util/tls.py``, minus the client
tools' ``-securityConfig`` flag helpers (the port has no client tool
yet). Every channel :func:`dial` opens carries the active trace context
in its call metadata.
"""

from __future__ import annotations

import datetime
import ipaddress
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

_LOCK = threading.Lock()
_INSTALLED: Optional["TlsConfig"] = None


@dataclass(frozen=True)
class TlsConfig:
    ca_cert: bytes
    cert: bytes
    key: bytes

    @classmethod
    def from_files(cls, ca: str | Path, cert: str | Path,
                   key: str | Path) -> "TlsConfig":
        return cls(ca_cert=Path(ca).read_bytes(),
                   cert=Path(cert).read_bytes(),
                   key=Path(key).read_bytes())

    def server_credentials(self):
        import grpc
        return grpc.ssl_server_credentials(
            [(self.key, self.cert)],
            root_certificates=self.ca_cert,
            require_client_auth=True)

    def channel_credentials(self):
        import grpc
        return grpc.ssl_channel_credentials(
            root_certificates=self.ca_cert,
            private_key=self.key,
            certificate_chain=self.cert)


def install(cfg: Optional[TlsConfig]) -> None:
    """Set (or clear) the process-global TLS config."""
    global _INSTALLED
    with _LOCK:
        _INSTALLED = cfg


def installed() -> Optional[TlsConfig]:
    return _INSTALLED


def install_from_config(conf: dict) -> bool:
    """Read security.toml's [grpc.tls] {ca, cert, key} paths; returns
    True when TLS was installed. An absent/empty section clears it; a
    PARTIAL section raises — silently falling back to plaintext when an
    operator misconfigured one path would defeat the whole point."""
    from . import config as config_mod
    ca = config_mod.lookup(conf, "grpc.tls.ca", "")
    cert = config_mod.lookup(conf, "grpc.tls.cert", "")
    key = config_mod.lookup(conf, "grpc.tls.key", "")
    present = [p for p in (ca, cert, key) if p]
    if present and len(present) < 3:
        raise ValueError(
            "[grpc.tls] must set all of ca/cert/key (or none); got "
            f"ca={ca!r} cert={cert!r} key={key!r}")
    if present:
        install(TlsConfig.from_files(ca, cert, key))
        return True
    install(None)
    return False


def dial(target: str, options=None):
    """Open a gRPC channel honoring the installed TLS config. Every
    channel carries the active trace context in call metadata."""
    import grpc

    from . import tracing
    cfg = _INSTALLED
    if cfg is None:
        channel = grpc.insecure_channel(target, options=options)
    else:
        channel = grpc.secure_channel(target, cfg.channel_credentials(),
                                      options=options)
    return tracing.grpc_trace_channel(channel)


def serve_port(server, address: str) -> int:
    """Bind ``server`` on ``address`` with the installed TLS config
    (mTLS) or plaintext when none; returns the bound port."""
    cfg = _INSTALLED
    if cfg is None:
        return server.add_insecure_port(address)
    return server.add_secure_port(address, cfg.server_credentials())


# --------------------------------------------------------------------------
# scaffold: self-signed CA + cluster pair
# --------------------------------------------------------------------------

def generate_cluster_credentials(directory: str | Path,
                                 hosts: tuple[str, ...] = ("localhost",),
                                 ips: tuple[str, ...] = ("127.0.0.1",),
                                 days: int = 365) -> dict:
    """Write ca.crt/ca.key + cluster.crt/cluster.key under ``directory``
    and return their paths. One shared pair serves every component of a
    localhost cluster (the reference ships separate master/volume/filer
    pairs; the seam is the same, the inventory smaller)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    not_after = now + datetime.timedelta(days=days)

    def _name(cn: str):
        return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])

    def _write_key(path: Path, key) -> None:
        path.write_bytes(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()))
        path.chmod(0o600)  # private keys must not be world-readable

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_cert = (x509.CertificateBuilder()
               .subject_name(_name("seaweedfs-tpu-ca"))
               .issuer_name(_name("seaweedfs-tpu-ca"))
               .public_key(ca_key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now).not_valid_after(not_after)
               .add_extension(x509.BasicConstraints(ca=True,
                                                    path_length=0),
                              critical=True)
               .sign(ca_key, hashes.SHA256()))

    leaf_key = ec.generate_private_key(ec.SECP256R1())
    san = x509.SubjectAlternativeName(
        [x509.DNSName(h) for h in hosts]
        + [x509.IPAddress(ipaddress.ip_address(i)) for i in ips])
    leaf_cert = (x509.CertificateBuilder()
                 .subject_name(_name("seaweedfs-tpu-cluster"))
                 .issuer_name(ca_cert.subject)
                 .public_key(leaf_key.public_key())
                 .serial_number(x509.random_serial_number())
                 .not_valid_before(now).not_valid_after(not_after)
                 .add_extension(san, critical=False)
                 .sign(ca_key, hashes.SHA256()))

    paths = {
        "ca": directory / "ca.crt",
        "ca_key": directory / "ca.key",
        "cert": directory / "cluster.crt",
        "key": directory / "cluster.key",
    }
    paths["ca"].write_bytes(
        ca_cert.public_bytes(serialization.Encoding.PEM))
    _write_key(paths["ca_key"], ca_key)
    paths["cert"].write_bytes(
        leaf_cert.public_bytes(serialization.Encoding.PEM))
    _write_key(paths["key"], leaf_key)
    return {k: str(v) for k, v in paths.items()}
