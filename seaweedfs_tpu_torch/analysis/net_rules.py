"""SW6xx — deadline / retry coverage rules.

The cluster plane has exactly one sanctioned way to speak HTTP:
``util/retry.http_request`` (jittered retries + per-request deadline +
circuit breaker + X-Seaweed-Deadline propagation). These rules police
the perimeter:

- SW601 (error): a raw ``urllib.request.urlopen`` / ``http.client
  HTTP(S)Connection`` / ``socket.create_connection`` call anywhere
  outside util/retry.py itself. Raw calls have no deadline, no
  breaker, and silently drop the cluster deadline header.
- SW602 (warning): a handler/job-path function (``do_GET``-style
  verbs, ``*_handler``, ``handle_*``, ``run_task*``, ``*_job``)
  *transitively* reaches a raw network call with no
  ``deadline_scope`` entered anywhere on the resolved call chain —
  an unbounded stall a client timeout cannot cancel server-side.
  Propagated over the same resolved call graph as the lock rules.
- SW603 (warning): a retry-shaped loop (``while`` + try/except +
  sleep) that consults neither a breaker nor a deadline nor a bounded
  attempt budget — the retry-storm shape util/retry exists to
  prevent.
"""

from __future__ import annotations

import ast
import re

from .dataflow import FlowProject, _dotted
from .findings import Finding

#: The one module allowed to make raw network calls: the wrapper.
_SANCTIONED_PATH = "util/retry.py"

_HANDLER_RE = re.compile(
    r"^do_[A-Z]+$|^handle(_|$)|_handler$|^run_task|_job$|^serve_request")

#: Evidence inside a retry loop that some budget bounds it.
_BUDGET_RE = re.compile(
    r"breaker|deadline|remaining\s*\(|expired\s*\(|attempt|n_tries|"
    r"max_tries|retries\b|budget", re.IGNORECASE)

_MAX_ROUNDS = 12


def _sw601(fp: FlowProject) -> list[Finding]:
    out = []
    for ff in fp.flows.values():
        if ff.path.endswith(_SANCTIONED_PATH):
            continue
        for desc, line in ff.summary.raw_net:
            out.append(Finding(
                "SW601", "error", ff.path, line, ff.key,
                f"raw network call {desc} bypasses "
                f"util.retry.http_request (no deadline, no breaker, "
                f"drops X-Seaweed-Deadline propagation)"))
    return out


def _sw602(fp: FlowProject) -> list[Finding]:
    # eff[f] = first raw-net site reachable from f with no
    # deadline_scope entered on the way (None = covered / none)
    eff: dict[str, tuple | None] = {}
    for key, ff in fp.flows.items():
        if ff.summary.enters_deadline or ff.path.endswith(
                _SANCTIONED_PATH):
            eff[key] = None
        elif ff.summary.raw_net:
            desc, line = ff.summary.raw_net[0]
            eff[key] = (desc, line, "")
    for _ in range(_MAX_ROUNDS):
        changed = False
        for key, ff in fp.flows.items():
            if key in eff:
                continue
            if ff.summary.enters_deadline:
                eff[key] = None
                continue
            for callee, line in ff.resolved_calls:
                hit = eff.get(callee)
                if hit is not None:
                    short = callee.split(":")[-1]
                    chain = f"{short}()" + (f" -> {hit[2]}" if hit[2]
                                            else "")
                    eff[key] = (hit[0], line, chain)
                    changed = True
                    break
        if not changed:
            break
    out = []
    for key, ff in fp.flows.items():
        if not _HANDLER_RE.search(ff.name):
            continue
        hit = eff.get(key)
        if hit is None:
            continue
        desc, line, chain = hit
        via = f" via {chain}" if chain else ""
        out.append(Finding(
            "SW602", "warning", ff.path, line, key,
            f"handler/job path reaches raw network call {desc}{via} "
            f"with no deadline_scope on the chain — an unbounded "
            f"stall the caller cannot cancel; wrap the path in "
            f"util.retry.deadline_scope or route through "
            f"http_request"))
    return out


def _net_in(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            d = _dotted(n.func)
            leaf = d.rsplit(".", 1)[-1]
            if leaf in ("urlopen", "http_request", "create_connection",
                        "HTTPConnection", "HTTPSConnection", "request",
                        "getresponse"):
                return True
    return False


def _sleep_in(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and \
                _dotted(n.func).rsplit(".", 1)[-1] == "sleep":
            return True
    return False


def _sw603(fp: FlowProject, sources: dict[str, str]) -> list[Finding]:
    out = []
    for ff in fp.flows.values():
        if ff.path.endswith(_SANCTIONED_PATH):
            continue
        body = ff.node
        for n in ast.walk(body):
            if not isinstance(n, ast.While):
                continue
            has_try = any(isinstance(x, ast.Try) for x in ast.walk(n))
            if not (has_try and _net_in(n) and _sleep_in(n)):
                continue
            lines = sources.get(ff.path, "").splitlines()
            end = getattr(n, "end_lineno", n.lineno) or n.lineno
            region = "\n".join(lines[n.lineno - 1:end])
            if _BUDGET_RE.search(region):
                continue
            out.append(Finding(
                "SW603", "warning", ff.path, n.lineno, ff.key,
                "retry loop (while + try/except + sleep around a "
                "network call) consults no breaker, deadline, or "
                "attempt budget — unbounded retry storm; use "
                "util.retry.http_request or check a CircuitBreaker/"
                "Deadline in the loop"))
    return out


def check_net(fp: FlowProject, sources: dict[str, str]) -> list[Finding]:
    return _sw601(fp) + _sw602(fp) + _sw603(fp, sources)
