"""Checked-in violation baseline: CI fails only on NEW findings.

The baseline is a JSON list of fingerprinted findings
(``seaweedfs_tpu_torch/analysis/baseline.json``). Fingerprints hash the rule
+ qualname + flagged source text — not line numbers — so unrelated
edits above a baselined site do not churn the file. Each entry may
carry a ``justification`` explaining why the violation is accepted;
``--write-baseline`` preserves justifications across rewrites.
"""

from __future__ import annotations

import json
from pathlib import Path

from .findings import Finding


def load_baseline(path: Path) -> dict:
    if not path.exists():
        return {"version": 1, "findings": []}
    data = json.loads(path.read_text())
    if not isinstance(data, dict) or "findings" not in data:
        raise ValueError(f"malformed baseline {path}: expected "
                         "{'version': 1, 'findings': [...]}")
    return data


def write_baseline(path: Path, findings: list[Finding],
                   previous: dict | None = None) -> dict:
    old_just = {e["fingerprint"]: e.get("justification", "")
                for e in (previous or {}).get("findings", [])}
    entries = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        e = f.to_json()
        just = old_just.get(f.fingerprint, "")
        if just:
            e["justification"] = just
        entries.append(e)
    data = {"version": 1, "findings": entries}
    path.write_text(json.dumps(data, indent=1) + "\n")
    return data


def diff_baseline(findings: list[Finding], baseline: dict
                  ) -> tuple[list[Finding], list[dict]]:
    """-> (new findings not in baseline, stale baseline entries)."""
    known = {e["fingerprint"] for e in baseline.get("findings", [])}
    current = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in known]
    stale = [e for e in baseline.get("findings", [])
             if e["fingerprint"] not in current]
    return new, stale


def prune_baseline(path: Path, findings: list[Finding]) -> list[dict]:
    """Drop baseline entries whose fingerprints match no current
    finding (``seaweedlint --prune-baseline``); justifications on
    surviving entries are untouched. Returns the pruned entries."""
    baseline = load_baseline(path)
    _new, stale = diff_baseline(findings, baseline)
    if stale:
        dead = {e["fingerprint"] for e in stale}
        baseline["findings"] = [e for e in baseline["findings"]
                                if e["fingerprint"] not in dead]
        path.write_text(json.dumps(baseline, indent=1) + "\n")
    return stale
