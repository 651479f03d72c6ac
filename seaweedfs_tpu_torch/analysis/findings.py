"""Finding record + stable fingerprints + inline pragma parsing."""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field

#: Ranked severities; the gate fails on anything >= its threshold.
SEVERITIES = ("info", "warning", "error")

_PRAGMA_RE = re.compile(
    r"#\s*seaweedlint:\s*disable=([A-Za-z0-9_,\s]+?)(?:\s*[—-]|$)")


@dataclass
class Finding:
    rule: str          # e.g. "SW103"
    severity: str      # "error" | "warning" | "info"
    path: str          # repo-relative posix path
    line: int          # 1-based
    qualname: str      # "module:Class.func" or "module:<module>"
    message: str
    fingerprint: str = ""
    extra: dict = field(default_factory=dict)

    def sort_key(self):
        return (-SEVERITIES.index(self.severity), self.path, self.line,
                self.rule)

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{self.severity}] {self.message}")

    def to_json(self) -> dict:
        return {"fingerprint": self.fingerprint, "rule": self.rule,
                "severity": self.severity, "path": self.path,
                "line": self.line, "qualname": self.qualname,
                "message": self.message}


def fingerprint_findings(findings: list[Finding],
                         sources: dict[str, str]) -> None:
    """Assign line-drift-stable fingerprints in place.

    Hash (rule, path, qualname, normalized source text of the flagged
    line) — NOT the line number, so inserting code above a finding does
    not churn the baseline. Identical lines in the same function get an
    occurrence index so two real violations never collapse into one
    baseline entry.
    """
    seen: dict[tuple, int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        lines = sources.get(f.path, "").splitlines()
        src = lines[f.line - 1].strip() if 0 < f.line <= len(lines) else ""
        base = (f.rule, f.path, f.qualname, src)
        n = seen.get(base, 0)
        seen[base] = n + 1
        raw = "|".join((*base[:3], src, str(n)))
        f.fingerprint = hashlib.sha1(raw.encode()).hexdigest()[:16]


_SARIF_LEVELS = {"error": "error", "warning": "warning", "info": "note"}

#: Per-rule SARIF metadata: short name, default severity, help text.
#: Rules not listed fall back to severity-derived metadata; the SW8xx
#: family is enumerated so editors render actionable guidance
#: (the README's port section holds the full catalog).
RULE_META: dict[str, dict] = {
    "SW801": {
        "name": "UnlockedSharedAttributeWrite",
        "severity": "error",
        "help": (
            "Attribute is written from two or more thread roles with "
            "an empty guaranteed-lockset intersection: no single lock "
            "consistently protects it. Guard every write with one "
            "lock, confine the attribute to a single thread, or "
            "pragma a deliberate single-writer/atomic-rebind design "
            "with a justification."),
    },
    "SW802": {
        "name": "CompoundUpdateOutsideLock",
        "severity": "warning",
        "help": (
            "Read-modify-write (`x += 1`) or check-then-set on a "
            "shared attribute outside any lock: two threads can "
            "interleave between the read and the write and lose an "
            "update. Take the guarding lock around the whole "
            "compound step."),
    },
    "SW803": {
        "name": "UnguardedSharedCollectionMutation",
        "severity": "warning",
        "help": (
            "A dict/list/set reachable from multiple thread roles is "
            "mutated without a lock. Single CPython ops are "
            "GIL-atomic, but iteration, multi-step updates, and "
            "free-threaded builds are not — guard the collection or "
            "document the single-writer protocol."),
    },
    "SW804": {
        "name": "PublishBeforeInit",
        "severity": "error",
        "help": (
            "`self` escapes to another thread (Thread(target=...), "
            "registry, callback) before __init__ finishes assigning "
            "attributes; the spawned thread can observe a half-built "
            "object. Finish construction, then publish."),
    },
}


def to_sarif(findings: list[Finding], tool_version: str = "2") -> dict:
    """SARIF 2.1.0 document for CI/editor consumption
    (``seaweedlint --format=sarif``). Rules with :data:`RULE_META`
    entries (the SW8xx race family) are emitted even when they have
    no findings in this run, so consumers always see their help text
    and default severity."""
    rules: dict[str, dict] = {}

    def rule_obj(rule: str, severity: str) -> dict:
        meta = RULE_META.get(rule)
        if meta is None:
            return {"id": rule,
                    "defaultConfiguration": {
                        "level": _SARIF_LEVELS.get(severity, "note")}}
        return {
            "id": rule,
            "name": meta["name"],
            "shortDescription": {"text": meta["name"]},
            "help": {"text": meta["help"]},
            "helpUri": "README.md",
            "defaultConfiguration": {
                "level": _SARIF_LEVELS.get(meta["severity"], "note")},
        }

    for rule in RULE_META:
        rules[rule] = rule_obj(rule, RULE_META[rule]["severity"])
    results = []
    for f in findings:
        rules.setdefault(f.rule, rule_obj(f.rule, f.severity))
        results.append({
            "ruleId": f.rule,
            "level": _SARIF_LEVELS.get(f.severity, "note"),
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(1, f.line)},
                },
                "logicalLocations": [{"fullyQualifiedName": f.qualname}],
            }],
            "partialFingerprints": {
                "seaweedlint/v1": f.fingerprint},
        })
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "seaweedlint",
                "version": tool_version,
                "informationUri": "README.md",
                "rules": sorted(rules.values(),
                                key=lambda r: r["id"]),
            }},
            "results": results,
        }],
    }


def suppressed_rules(source_line: str) -> set[str]:
    """Rules disabled by an inline pragma on this source line.

    ``# seaweedlint: disable=SW103,SW201 — holding the cache lock over
    the disk tier is the design``  →  {"SW103", "SW201"}; ``disable=all``
    suppresses every rule on the line.
    """
    m = _PRAGMA_RE.search(source_line)
    if not m:
        return set()
    return {r.strip() for r in m.group(1).split(",") if r.strip()}


def is_suppressed(finding: Finding, sources: dict[str, str],
                  anchor_lines: tuple[int, ...] = ()) -> bool:
    """A pragma suppresses on the flagged line, the line above it, or
    any anchor line (e.g. the ``with <lock>:`` statement a blocking
    call was found under) and the line above that."""
    lines = sources.get(finding.path, "").splitlines()
    candidates = []
    for ln in (finding.line, *anchor_lines):
        candidates.extend((ln, ln - 1))
    for ln in candidates:
        if 0 < ln <= len(lines):
            rules = suppressed_rules(lines[ln - 1])
            if "all" in rules or finding.rule in rules:
                return True
    return False
