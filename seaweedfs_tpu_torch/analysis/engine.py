"""Analysis driver: walk files -> per-module models -> findings.

Pass an empty dict as ``timings`` to either analyze_* entry point to
get per-rule-family wall time back (the ``--stats`` report and the
lint_gate runtime budget both read it).
"""

from __future__ import annotations

import ast
import time
from pathlib import Path

from .buffer_rules import check_buffers
from .dataflow import build_flows
from .durability_rules import check_durability
from .findings import Finding, fingerprint_findings, is_suppressed
from .torch_rules import check_torch
from .local_rules import check_local
from .lockgraph import Project, analyze_locks
from .model import ModuleInfo, collect_module
from .net_rules import check_net
from .race_rules import check_races

#: Generated / vendored files the rules should not police.
_EXCLUDE_PARTS = {"__pycache__"}
_EXCLUDE_SUFFIXES = ("_pb2.py",)


def discover_files(paths: list[str], root: Path) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        path = (root / p) if not Path(p).is_absolute() else Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            files.append(path)
    out = []
    for f in files:
        if set(f.parts) & _EXCLUDE_PARTS:
            continue
        if f.name.endswith(_EXCLUDE_SUFFIXES):
            continue
        out.append(f)
    return out


def module_name_for(path: Path, root: Path) -> str:
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        return path.stem
    parts = list(rel.parts)
    parts[-1] = parts[-1][:-3]  # .py
    if parts[-1] == "__init__":
        parts = parts[:-1] or [path.parent.name]
    return ".".join(parts)


def analyze_sources(sources: dict[str, str],
                    module_names: dict[str, str] | None = None,
                    timings: dict[str, float] | None = None,
                    suppressed_out: list[Finding] | None = None
                    ) -> list[Finding]:
    """Analyze {repo-relative path: source text}. The unit the tests
    drive: no filesystem involved.

    ``suppressed_out``, when given, receives the findings an inline
    pragma silenced (the lint_gate summary table counts them).
    """
    t = timings if timings is not None else {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        t[label] = t.get(label, 0.0) + (time.perf_counter() - t0)
        return out

    modules: dict[str, ModuleInfo] = {}
    findings: list[Finding] = []

    def parse():
        for path, src in sorted(sources.items()):
            name = (module_names or {}).get(path) or \
                path[:-3].replace("/", ".")
            try:
                modules[name] = collect_module(name, path, src)
            except SyntaxError as e:
                findings.append(Finding(
                    "SW001", "error", path, e.lineno or 1,
                    f"{name}:<module>", f"syntax error: {e.msg}"))

    timed("parse+model", parse)

    def local():
        out = []
        for mi in modules.values():
            out.extend(check_local(mi))
        return out

    findings.extend(timed("SW2xx-SW4xx local", local))

    proj = timed("callgraph", lambda: Project(modules))
    findings.extend(timed("SW1xx lockgraph",
                          lambda: analyze_locks(modules, proj)))
    fp = timed("dataflow fixpoint", lambda: build_flows(modules, proj))
    findings.extend(timed("SW5xx buffer", lambda: check_buffers(fp)))
    findings.extend(timed("SW6xx net", lambda: check_net(fp, sources)))
    findings.extend(timed("SW7xx torch",
                          lambda: check_torch(modules, proj)))
    findings.extend(timed("SW8xx races", lambda: check_races(fp)))
    findings.extend(timed("SW9xx durability",
                          lambda: check_durability(modules)))

    def finish():
        kept = []
        for f in findings:
            if is_suppressed(f, sources,
                             tuple(f.extra.get("anchors", ()))):
                if suppressed_out is not None:
                    suppressed_out.append(f)
            else:
                kept.append(f)
        fingerprint_findings(kept, sources)
        kept.sort(key=Finding.sort_key)
        return kept

    return timed("suppress+fingerprint", finish)


def analyze_paths(paths: list[str], root: Path,
                  timings: dict[str, float] | None = None,
                  suppressed_out: list[Finding] | None = None
                  ) -> list[Finding]:
    files = discover_files(paths, root)
    sources: dict[str, str] = {}
    names: dict[str, str] = {}
    for f in files:
        try:
            rel = str(f.resolve().relative_to(root.resolve()))
        except ValueError:
            rel = str(f)
        sources[rel] = f.read_text(encoding="utf-8",
                                   errors="replace")
        names[rel] = module_name_for(f, root)
    return analyze_sources(sources, names, timings,
                           suppressed_out=suppressed_out)


def parse_ok(source: str) -> bool:
    """Cheap helper for tests."""
    try:
        ast.parse(source)
        return True
    except SyntaxError:
        return False
