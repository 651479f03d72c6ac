"""Per-path storage rules (the reference's filer.conf / fs.configure).

Mirrors weed/filer's FilerConf behavior: a JSON document stored IN the
filer at :data:`FILER_CONF_PATH` lists location rules —

    {"locations": [{"locationPrefix": "/buckets/hot/",
                    "collection": "hot",
                    "replication": "010",
                    "ttl": "1d"}]}

— and server-side writes under a prefix inherit that rule's collection
/replication/ttl unless the request names its own. The longest
matching prefix wins. The filer server loads the document at startup
and re-reads it whenever its own metadata stream reports a change
under the config directory (shell ``fs.configure`` edits it), so rules
apply live to the filer HTTP write path and everything that writes
through it (S3 gateway, WebDAV). The FUSE mount assigns chunks
directly against the master and keeps its own ``-collection`` flag,
like the reference's mount.

The port of ``seaweedfs_tpu/filer/path_conf.py``, whole.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

FILER_CONF_DIR = "/etc/seaweedfs"
FILER_CONF_PATH = FILER_CONF_DIR + "/filer.conf"


@dataclass(frozen=True)
class PathRule:
    location_prefix: str
    collection: str = ""
    replication: str = ""
    ttl: str = ""

    def to_json(self) -> dict:
        d = {"locationPrefix": self.location_prefix}
        if self.collection:
            d["collection"] = self.collection
        if self.replication:
            d["replication"] = self.replication
        if self.ttl:
            d["ttl"] = self.ttl
        return d


class PathConf:
    """Ordered rule set with longest-prefix matching."""

    def __init__(self, rules: Optional[list[PathRule]] = None):
        self.rules = sorted(rules or [],
                            key=lambda r: len(r.location_prefix),
                            reverse=True)

    @classmethod
    def parse(cls, raw: bytes | str) -> "PathConf":
        cfg = json.loads(raw)
        rules = [PathRule(
            location_prefix=loc.get("locationPrefix", ""),
            collection=loc.get("collection", ""),
            replication=loc.get("replication", ""),
            ttl=loc.get("ttl", ""))
            for loc in cfg.get("locations", [])
            if loc.get("locationPrefix")]
        return cls(rules)

    def match(self, path: str) -> Optional[PathRule]:
        """Longest-prefix rule for ``path`` (rules are pre-sorted by
        descending prefix length, so the first hit wins)."""
        for r in self.rules:
            if path.startswith(r.location_prefix):
                return r
        return None

    def __len__(self) -> int:
        return len(self.rules)
