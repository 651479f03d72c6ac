"""Incremental result cache for seaweedlint runs.

Every analysis family in the engine is INTERPROCEDURAL — lock order,
buffer dataflow, and the SW8xx thread-role model all propagate facts
over the resolved call graph — so a finding in file A can appear or
vanish when only file B changes. A per-file cache that re-analyzed
changed files in isolation would therefore be unsound (it would miss
cross-file regressions, the worst kind to miss). The cache instead
keeps per-file keys — ``(repo-relative path, mtime_ns, size)`` — plus
a rules version (a hash of the analysis package's own sources, so
editing any rule module invalidates everything), and reuses the
stored run only when EVERY key matches and the file set is identical.
Any mismatch discards the whole entry and re-runs the full analysis.

That all-or-nothing validity rule still pays for the common CI/editor
loop — "nothing changed since the last run" — which drops a ~5 s
analysis to a few dozen ``stat()`` calls. Hit/miss counts stay per
file so ``--stats`` can show how close a run was to reuse.

The cache file lives at the repo root (``.seaweedlint_torch_cache.json``,
gitignored; apart from the JAX linter's, so the two never thrash one
file) and is written atomically (tmp + ``os.replace``) so an
interrupted run can never leave a torn entry. ``--no-cache`` bypasses
both the probe and the store.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

from .engine import discover_files
from .findings import Finding

#: Bump when the on-disk entry layout changes.
CACHE_FORMAT = 1

#: Repo-root-relative cache file name (kept out of git).
DEFAULT_CACHE = ".seaweedlint_torch_cache.json"


def rules_version() -> str:
    """Hash of the analyzer's OWN sources (every ``analysis/*.py``).

    Findings depend on the rules as much as on the analyzed files, so
    editing any rule module must invalidate every cached result.
    """
    h = hashlib.sha1()
    pkg = Path(__file__).resolve().parent
    for p in sorted(pkg.glob("*.py")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def file_keys(paths: list[str], root: Path) -> dict[str, list[int]]:
    """``{repo-relative path: [mtime_ns, size]}`` for the exact file
    set the engine would analyze (same discovery walk, same excludes).
    """
    keys: dict[str, list[int]] = {}
    for f in discover_files(paths, root):
        try:
            rel = str(f.resolve().relative_to(root.resolve()))
        except ValueError:
            rel = str(f)
        # a file deleted mid-walk simply stays out of the key map —
        # the set mismatch forces a full re-run, which is the point
        try:
            st = f.stat()
        except OSError:  # seaweedlint: disable=SW301 — vanished file = cache miss by design
            continue
        keys[rel] = [st.st_mtime_ns, st.st_size]
    return keys


def _to_entry(f: Finding) -> dict:
    return {"rule": f.rule, "severity": f.severity, "path": f.path,
            "line": f.line, "qualname": f.qualname,
            "message": f.message, "fingerprint": f.fingerprint,
            "extra": f.extra}


def _from_entry(d: dict) -> Finding:
    return Finding(d["rule"], d["severity"], d["path"], d["line"],
                   d["qualname"], d["message"],
                   d.get("fingerprint", ""), dict(d.get("extra", {})))


def _jsonable(obj):
    # Finding.extra holds tuples/sets (anchor line numbers etc.);
    # their exact container type is irrelevant once suppression has
    # already run, so lists are a faithful-enough round trip.
    if isinstance(obj, (tuple, set, frozenset)):
        return sorted(obj) if isinstance(obj, (set, frozenset)) \
            else list(obj)
    return str(obj)


def load(cache_path: Path, version: str,
         keys: dict[str, list[int]]
         ) -> tuple[tuple[list[Finding], list[Finding]] | None,
                    int, int]:
    """Probe the cache against the current ``(version, keys)``.

    Returns ``(entry, hits, misses)`` where ``entry`` is
    ``(findings, suppressed)`` on a full hit and ``None`` otherwise;
    ``hits``/``misses`` count per-file key matches either way (a
    deleted file counts as a miss — the file SET must match too).
    """
    try:
        data = json.loads(cache_path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None, 0, len(keys)
    if data.get("cache_format") != CACHE_FORMAT or \
            data.get("rules_version") != version:
        return None, 0, len(keys)
    old = data.get("files", {})
    hits = sum(1 for p, k in keys.items() if old.get(p) == k)
    misses = (len(keys) - hits) + \
        sum(1 for p in old if p not in keys)
    if misses:
        return None, hits, misses
    try:
        findings = [_from_entry(d) for d in data.get("findings", [])]
        suppressed = [_from_entry(d)
                      for d in data.get("suppressed", [])]
    except (KeyError, TypeError):
        return None, 0, len(keys)
    return (findings, suppressed), hits, 0


def store(cache_path: Path, version: str, keys: dict[str, list[int]],
          findings: list[Finding], suppressed: list[Finding]) -> None:
    """Atomically persist a completed run. Best-effort: a read-only
    checkout just runs uncached."""
    data = {
        "cache_format": CACHE_FORMAT,
        "rules_version": version,
        "files": keys,
        "findings": [_to_entry(f) for f in findings],
        "suppressed": [_to_entry(f) for f in suppressed],
    }
    tmp = cache_path.with_name(cache_path.name + ".tmp")
    try:
        tmp.write_text(json.dumps(data, default=_jsonable),
                       encoding="utf-8")
        # seaweedlint: disable=SW901 — pure-speedup cache; losing it re-lints, fsync would slow every run
        os.replace(tmp, cache_path)
    except OSError:
        # cache writes are pure speedup — a read-only checkout or a
        # full disk must not fail the lint run itself
        try:
            tmp.unlink()
        except OSError:  # seaweedlint: disable=SW301 — best-effort tmp cleanup on a best-effort write
            pass
