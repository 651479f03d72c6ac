"""Cross-module lock-acquisition graph + blocking-I/O-under-lock.

Consumes the per-module models, resolves the call graph (self-methods,
module functions, imported functions, ``self.attr.meth()`` via inferred
attribute types, and project-unique method names), propagates "locks
acquired" and "blocking I/O performed" sets to a fixpoint, then:

- SW101 (error): cycles in the lock-order digraph — two locks taken in
  both orders somewhere in the project — and non-reentrant
  ``threading.Lock`` self-cycles.
- SW102 (info): every nested-acquire site (graph edge), so reviewers
  can audit the ordering discipline the cycle check depends on.
- SW103: blocking I/O while a lock is held — directly or through any
  resolved call chain. sleep/socket/network/rpc/subprocess are errors;
  local file I/O is a warning (bounded latency, still worth knowing).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .findings import Finding
from .model import FuncInfo, ModuleInfo

_ERROR_CATEGORIES = {"sleep", "socket", "network", "rpc", "subprocess"}
_MAX_ROUNDS = 12


@dataclass
class _Edge:
    outer: str
    inner: str
    path: str
    line: int
    qualname: str
    via: str = ""      # call-chain text for indirect edges


@dataclass
class Project:
    modules: dict[str, ModuleInfo]
    funcs: dict[str, FuncInfo] = field(default_factory=dict)
    lock_kinds: dict[str, str] = field(default_factory=dict)
    #: method name -> {class_key} across the whole project
    method_owners: dict[str, set[str]] = field(default_factory=dict)

    def __post_init__(self):
        for mi in self.modules.values():
            for d in mi.module_locks.values():
                self.lock_kinds[d.lock_id] = d.kind
            for f in mi.functions.values():
                self.funcs[f.key] = f
            for cname, ci in mi.classes.items():
                for d in ci.lock_defs.values():
                    self.lock_kinds[d.lock_id] = d.kind
                for mname, f in ci.methods.items():
                    self.funcs[f.key] = f
                    self.method_owners.setdefault(mname, set()).add(
                        f"{mi.name}:{cname}")

    def kind(self, lock_id: str) -> str:
        return self.lock_kinds.get(lock_id, "unknown")


def resolve_call(proj: Project, mi: ModuleInfo, caller: FuncInfo,
                 ref: tuple) -> Optional[str]:
    """CallRef -> FuncInfo key, or None when it leaves the project.

    Shared with the value-flow engine (dataflow.py): both layers
    resolve call sites against the same project call graph.
    """
    if ref[0] == "self":
        cls = caller.key.rsplit(":", 1)[1].split(".")[0] \
            if "." in caller.key.rsplit(":", 1)[1] else None
        if cls:
            key = f"{mi.name}:{cls}.{ref[1]}"
            if key in proj.funcs:
                return key
        return None
    if ref[0] == "name":
        key = f"{mi.name}:{ref[1]}"
        if key in proj.funcs:
            return key
        tgt = mi.from_imports.get(ref[1])
        if tgt:
            key = f"{tgt[0]}:{tgt[1]}"
            if key in proj.funcs:
                return key
        return None
    if ref[0] == "alias":
        mod = mi.imports.get(ref[1])
        if mod:
            key = f"{mod}:{ref[2]}"
            if key in proj.funcs:
                return key
        return None
    if ref[0] == "selfattr":
        cls = caller.key.rsplit(":", 1)[1].split(".")[0] \
            if "." in caller.key.rsplit(":", 1)[1] else None
        ci = mi.classes.get(cls) if cls else None
        if ci is not None:
            cls_key = ci.attr_types.get(ref[1])
            if cls_key:
                key = f"{cls_key}.{ref[2]}"
                if key in proj.funcs:
                    return key
        # fall through to the uniqueness heuristic
        ref = ("unique", ref[2])
    if ref[0] == "unique":
        owners = proj.method_owners.get(ref[1], set())
        if len(owners) == 1:
            return f"{next(iter(owners))}.{ref[1]}"
    return None


def _fixpoint(proj: Project):
    """Propagate acquired-lock and blocking sets over the call graph.

    eff_locks[f]  : lock_id -> short call-chain string ("" = direct)
    eff_block[f]  : category -> (description, chain string)
    """
    eff_locks: dict[str, dict[str, str]] = {}
    eff_block: dict[str, dict[str, tuple[str, str]]] = {}
    resolved: dict[str, list[tuple[str, int, tuple, tuple]]] = {}
    for key, f in proj.funcs.items():
        eff_locks[key] = {lid: "" for lid in f.acquires}
        eff_block[key] = {cat: (desc, "")
                          for cat, desc, _ln, _h, _w in f.blocking}
        mi = proj.modules[f.module]
        resolved[key] = [
            (callee, line, held, wlines)
            for ref, line, held, wlines in f.calls
            if (callee := resolve_call(proj, mi, f, ref)) is not None]

    for _ in range(_MAX_ROUNDS):
        changed = False
        for key, calls in resolved.items():
            for callee, _line, _held, _w in calls:
                short = callee.split(":")[-1]
                for lid, chain in eff_locks.get(callee, {}).items():
                    if lid not in eff_locks[key]:
                        eff_locks[key][lid] = \
                            f"{short} -> {chain}" if chain else short
                        changed = True
                for cat, (desc, chain) in eff_block.get(callee,
                                                        {}).items():
                    if cat not in eff_block[key]:
                        eff_block[key][cat] = (
                            desc, f"{short} -> {chain}" if chain
                            else short)
                        changed = True
        if not changed:
            break
    return eff_locks, eff_block, resolved


def _cycles(edges: list[_Edge]) -> list[list[str]]:
    """Elementary cycles via DFS over the lock digraph (it is tiny)."""
    adj: dict[str, set[str]] = {}
    for e in edges:
        adj.setdefault(e.outer, set()).add(e.inner)
    cycles: list[list[str]] = []
    seen_cycles: set[tuple[str, ...]] = set()

    def dfs(start: str, node: str, path: list[str],
            on_path: set[str]) -> None:
        for nxt in sorted(adj.get(node, ())):
            if nxt == start and len(path) > 1:
                # canonicalize rotation so each cycle reports once
                i = path.index(min(path))
                canon = tuple(path[i:] + path[:i])
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    cycles.append(list(canon))
            elif nxt not in on_path and nxt > start:
                # only walk nodes > start: each cycle found from its
                # minimal node exactly once
                dfs(start, nxt, path + [nxt], on_path | {nxt})

    for n in sorted(adj):
        dfs(n, n, [n], {n})
    return cycles


def analyze_locks(modules: dict[str, ModuleInfo],
                  proj: Optional[Project] = None) -> list[Finding]:
    if proj is None:
        proj = Project(modules)
    eff_locks, eff_block, resolved = _fixpoint(proj)

    findings: list[Finding] = []
    edges: list[_Edge] = []

    for key, f in proj.funcs.items():
        mi = proj.modules[f.module]

        for outer, inner, line in f.nest_edges:
            edges.append(_Edge(outer, inner, mi.path, line, key))

        for callee, line, held, wlines in resolved[key]:
            for lid, chain in eff_locks.get(callee, {}).items():
                for h in held:
                    if h == lid and proj.kind(lid) != "Lock":
                        continue
                    via = callee.split(":")[-1] + \
                        (f" -> {chain}" if chain else "")
                    edges.append(_Edge(h, lid, mi.path, line, key,
                                       via=via))
            for cat, (desc, chain) in eff_block.get(callee, {}).items():
                if not held or callee == key:
                    continue
                sev = "error" if cat in _ERROR_CATEGORIES else "warning"
                via = callee.split(":")[-1] + \
                    (f" -> {chain}" if chain else "")
                findings.append(Finding(
                    "SW103", sev, mi.path, line, key,
                    f"{desc} ({cat}) reached via {via} while holding "
                    f"{', '.join(held)}",
                    extra={"anchors": wlines}))

        for cat, desc, line, held, wlines in f.blocking:
            if not held:
                continue
            sev = "error" if cat in _ERROR_CATEGORIES else "warning"
            findings.append(Finding(
                "SW103", sev, mi.path, line, key,
                f"{desc} ({cat} I/O) while holding {', '.join(held)}",
                extra={"anchors": wlines}))

    # one SW102 note per distinct nested-acquire site
    seen_sites: set[tuple] = set()
    for e in edges:
        site = (e.path, e.line, e.outer, e.inner)
        if e.outer == e.inner or site in seen_sites:
            continue
        seen_sites.add(site)
        suffix = f" via {e.via}" if e.via else ""
        findings.append(Finding(
            "SW102", "info", e.path, e.line, e.qualname,
            f"nested lock acquisition: {e.outer} -> {e.inner}{suffix}"))

    # self-cycles on a non-reentrant Lock are immediate deadlocks
    for e in edges:
        if e.outer == e.inner and proj.kind(e.outer) == "Lock":
            findings.append(Finding(
                "SW101", "error", e.path, e.line, e.qualname,
                f"non-reentrant threading.Lock {e.outer} re-acquired "
                f"while already held"
                + (f" via {e.via}" if e.via else "")))

    by_pair: dict[tuple[str, str], _Edge] = {}
    for e in edges:
        if e.outer != e.inner:
            by_pair.setdefault((e.outer, e.inner), e)
    for cyc in _cycles([e for e in by_pair.values()]):
        e = by_pair[(cyc[0], cyc[1 % len(cyc)])]
        order = " -> ".join(cyc + [cyc[0]])
        sites = "; ".join(
            f"{by_pair[(a, b)].path}:{by_pair[(a, b)].line}"
            for a, b in zip(cyc, cyc[1:] + cyc[:1]))
        findings.append(Finding(
            "SW101", "error", e.path, e.line, e.qualname,
            f"lock-order cycle: {order} (sites: {sites})"))

    return findings
