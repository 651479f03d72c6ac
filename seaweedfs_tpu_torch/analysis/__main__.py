"""seaweedlint CLI.

    python -m seaweedfs_tpu_torch.analysis [paths...]
        [--baseline FILE | --no-baseline] [--write-baseline]
        [--prune-baseline] [--fail-stale]
        [--gate error|warning|none] [--format human|json|sarif]
        [--stats] [--families] [--no-cache]
        [--budget-seconds S] [--verbose]

Exit codes: 0 clean (or all findings baselined), 1 new findings at or
above the gate severity (or stale baseline under --fail-stale, or
runtime over --budget-seconds), 2 bad invocation.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import cache as result_cache
from .baseline import (diff_baseline, load_baseline, prune_baseline,
                       write_baseline)
from .engine import analyze_paths
from .findings import SEVERITIES, Finding, to_sarif

_REPO_ROOT = Path(__file__).resolve().parents[2]
_DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def _summarize(findings: list[Finding]) -> str:
    by = {s: 0 for s in SEVERITIES}
    for f in findings:
        by[f.severity] += 1
    return (f"{len(findings)} finding(s): {by['error']} error, "
            f"{by['warning']} warning, {by['info']} info")


def _print_stats(timings: dict[str, float], total: float) -> None:
    print("seaweedlint --stats: per-rule-family wall time")
    width = max(len(k) for k in timings) if timings else 10
    for label, secs in sorted(timings.items(), key=lambda kv: -kv[1]):
        share = 100.0 * secs / total if total else 0.0
        print(f"  {label:<{width}}  {secs:7.3f}s  {share:5.1f}%")
    print(f"  {'total':<{width}}  {total:7.3f}s")


def _family(rule: str) -> str:
    # "SW103" -> "SW1xx"; anything oddly shaped keeps its own row
    return rule[:3] + "xx" if len(rule) == 5 and \
        rule.startswith("SW") else rule


def _family_table(findings: list[Finding], new: list[Finding],
                  suppressed: list[Finding]) -> list[str]:
    """Per-rule-family triage table: how many findings are NEW (would
    gate), how many ride in the baseline, how many an inline pragma
    deliberately silenced, plus ungated info chatter."""
    new_ids = {id(f) for f in new}
    fams: dict[str, list[int]] = {}

    def row(rule):
        return fams.setdefault(_family(rule), [0, 0, 0, 0])

    for f in findings:
        if f.severity == "info":
            row(f.rule)[3] += 1
        elif id(f) in new_ids:
            row(f.rule)[0] += 1
        else:
            row(f.rule)[1] += 1
    for f in suppressed:
        row(f.rule)[2] += 1
    lines = ["seaweedlint --families: findings by rule family",
             f"  {'family':<8}{'new':>6}{'baselined':>11}"
             f"{'pragma-d':>10}{'info':>6}"]
    total = [0, 0, 0, 0]
    for fam in sorted(fams):
        n, b, p, i = fams[fam]
        total = [total[0] + n, total[1] + b,
                 total[2] + p, total[3] + i]
        lines.append(f"  {fam:<8}{n:>6}{b:>11}{p:>10}{i:>6}")
    lines.append(f"  {'total':<8}{total[0]:>6}{total[1]:>11}"
                 f"{total[2]:>10}{total[3]:>6}")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="seaweedlint",
        description="project-native concurrency & resource analyzer")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to analyze "
                         "(default: seaweedfs_tpu_torch)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline file (default {_DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignore the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(preserves justifications)")
    ap.add_argument("--prune-baseline", action="store_true",
                    help="drop baseline entries whose fingerprints no "
                         "longer match any finding, keep the rest")
    ap.add_argument("--fail-stale", action="store_true",
                    help="exit non-zero when stale baseline entries "
                         "remain (CI mode)")
    ap.add_argument("--gate", choices=["error", "warning", "none"],
                    default="warning",
                    help="fail on new findings at/above this severity "
                         "(default: warning)")
    ap.add_argument("--format", choices=["human", "json", "sarif"],
                    default=None, dest="fmt",
                    help="output format (default: human)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="alias for --format=json")
    ap.add_argument("--stats", action="store_true",
                    help="print per-rule-family wall time and cache "
                         "hit/miss counts")
    ap.add_argument("--families", action="store_true",
                    help="print a per-rule-family triage table "
                         "(new vs baselined vs pragma'd)")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore and do not write the incremental "
                         "result cache (.seaweedlint_torch_cache.json)")
    ap.add_argument("--budget-seconds", type=float, default=0.0,
                    help="fail if the analysis run exceeds this many "
                         "seconds (0 = no budget)")
    ap.add_argument("--verbose", action="store_true",
                    help="also print info-level findings")
    args = ap.parse_args(argv)

    fmt = args.fmt or ("json" if args.as_json else "human")
    root = _REPO_ROOT
    paths = args.paths or ["seaweedfs_tpu_torch"]
    timings: dict[str, float] = {}
    suppressed: list[Finding] = []
    t0 = time.perf_counter()
    # Incremental cache: reuse the previous run's findings when no
    # analyzed file (and no rule module) changed — see cache.py for
    # why reuse is all-or-nothing. The probe itself is just stats.
    findings = None
    cache_hits = cache_misses = 0
    cache_state = "disabled"
    cache_path = root / result_cache.DEFAULT_CACHE
    if not args.no_cache:
        version = result_cache.rules_version()
        keys = result_cache.file_keys(paths, root)
        entry, cache_hits, cache_misses = result_cache.load(
            cache_path, version, keys)
        if entry is not None:
            findings, suppressed = entry
            cache_state = "hit"
        else:
            cache_state = "miss"
    if findings is None:
        findings = analyze_paths(paths, root, timings,
                                 suppressed_out=suppressed)
        if not args.no_cache:
            result_cache.store(cache_path, version, keys,
                               findings, suppressed)
    elapsed = time.perf_counter() - t0

    baseline_path = args.baseline or _DEFAULT_BASELINE
    if args.write_baseline:
        prev = load_baseline(baseline_path)
        gated = [f for f in findings if f.severity != "info"]
        write_baseline(baseline_path, gated, prev)
        print(f"wrote {len(gated)} finding(s) to {baseline_path}")
        return 0
    if args.prune_baseline:
        pruned = prune_baseline(
            baseline_path, [f for f in findings
                            if f.severity != "info"])
        print(f"pruned {len(pruned)} stale entr"
              f"{'y' if len(pruned) == 1 else 'ies'} from "
              f"{baseline_path}")
        for e in pruned:
            print(f"  - {e['rule']} {e['path']}:{e.get('line', '?')} "
                  f"{e['fingerprint']}")
        return 0

    if args.no_baseline:
        new, stale = findings, []
    else:
        baseline = load_baseline(baseline_path)
        new, stale = diff_baseline(
            [f for f in findings if f.severity != "info"], baseline)
        new = new + [f for f in findings if f.severity == "info"]

    gate_rank = {"none": len(SEVERITIES), "warning": 1, "error": 2}
    threshold = gate_rank[args.gate]
    gating = [f for f in new
              if SEVERITIES.index(f.severity) >= threshold]
    shown = [f for f in new
             if args.verbose or f.severity != "info"]

    over_budget = args.budget_seconds > 0 and \
        elapsed > args.budget_seconds
    stale_fail = args.fail_stale and bool(stale)

    if fmt == "json":
        print(json.dumps({
            "findings": [f.to_json() for f in shown],
            "gating": len(gating),
            "stale_baseline": stale,
            "summary": _summarize(findings),
            "elapsed_seconds": round(elapsed, 3),
        }, indent=1))
    elif fmt == "sarif":
        print(json.dumps(to_sarif(shown), indent=1))
    else:
        for f in shown:
            print(f.format())
        if stale:
            print(f"note: {len(stale)} baseline entr"
                  f"{'y is' if len(stale) == 1 else 'ies are'} stale "
                  f"(fixed) — run --prune-baseline to drop them")
        print(f"seaweedlint: {_summarize(findings)}; "
              f"{len(gating)} new at gate severity "
              f"'{args.gate}'")
    if args.families and fmt == "human":
        for line in _family_table(findings, new, suppressed):
            print(line)
    if args.stats:
        _print_stats(timings, elapsed)
        print(f"  cache: {cache_state} ({cache_hits} file(s) "
              f"unchanged, {cache_misses} changed/new/removed)")
    if over_budget:
        print(f"seaweedlint: runtime budget exceeded: {elapsed:.1f}s "
              f"> {args.budget_seconds:.1f}s", file=sys.stderr)
    if stale_fail:
        print(f"seaweedlint: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} (--fail-stale); "
              f"run python -m seaweedfs_tpu_torch.analysis "
              f"--prune-baseline",
              file=sys.stderr)
    return 1 if (gating or over_budget or stale_fail) else 0


if __name__ == "__main__":
    sys.exit(main())
