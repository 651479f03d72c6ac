"""Per-file rules: resource hygiene, swallowed exceptions, metrics.

These need no cross-module resolution, but they do reuse the parsed
tree held by ModuleInfo so each file is parsed once.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from .findings import Finding
from .model import ModuleInfo

#: function names whose silent except handlers are errors, not
#: warnings: background loops where a swallowed exception means a
#: silently dead server thread (heartbeat/reaper/pusher/sync...).
_LOOPY_FN_RE = re.compile(
    r"(heartbeat|_loop|^_?run\b|serve|reap|worker|daemon|push|watch"
    r"|sync|vacuum)", re.IGNORECASE)

_LOG_CALL_RE = re.compile(
    r"(glog|logging|logger|log)\.(v|info|warning|error|exception|debug"
    r"|critical)$")


# ---------------------------------------------------------------------------
# SW201 / SW202 — resource hygiene
# ---------------------------------------------------------------------------

def _opener(node: ast.Call, mi: ModuleInfo) -> Optional[str]:
    """Classify a call that creates a closeable resource."""
    fn = node.func
    if isinstance(fn, ast.Name):
        if fn.id == "open":
            return "file handle"
        if fn.id == "socket":
            tgt = mi.from_imports.get("socket")
            if tgt and tgt[0] == "socket":
                return "socket"
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        mod = mi.imports.get(fn.value.id, "")
        if mod == "socket" and fn.attr in ("socket",
                                           "create_connection"):
            return "socket"
        if mod == "grpc" and fn.attr in ("insecure_channel",
                                         "secure_channel"):
            return "gRPC channel"
        if fn.attr == "dial":  # util/tls.py dial() -> grpc channel
            return "gRPC channel"
    return None


def _is_span_call(node: ast.Call, mi: ModuleInfo) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        mod = mi.imports.get(fn.value.id, "")
        return fn.attr in ("span", "start_trace") and \
            mod.endswith("tracing")
    if isinstance(fn, ast.Name):
        tgt = mi.from_imports.get(fn.id)
        return tgt is not None and tgt[1] in ("span", "start_trace") \
            and tgt[0].endswith("tracing")
    return False


_SCOPE_BOUNDARY = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                   ast.Lambda)


def _walk_scope(root: ast.AST):
    """ast.walk that does NOT descend into nested function/class
    scopes — their bodies run under their own locks and lifetimes."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _SCOPE_BOUNDARY):
            stack.extend(ast.iter_child_nodes(node))


class _FuncResourceCheck(ast.NodeVisitor):
    """Within one function body: resources opened vs. closed."""

    def __init__(self, mi: ModuleInfo, qualname: str,
                 findings: list[Finding]):
        self.mi = mi
        self.qualname = qualname
        self.findings = findings
        #: var -> (kind, line) for resources assigned to a local name
        self.opened: dict[str, tuple[str, int]] = {}
        self.closed: dict[str, list[int]] = {}      # var -> close lines
        self.escaped: set[str] = set()              # ownership left fn
        self.finally_ranges: list[tuple[int, int]] = []
        self.with_lines: set[int] = set()

    # nested scopes manage their own resources — do not descend
    def visit_FunctionDef(self, node) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    # -- collection --

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            self.with_lines.add(item.context_expr.lineno)
            if isinstance(item.context_expr, ast.Name):
                self.escaped.add(item.context_expr.id)
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def visit_Try(self, node: ast.Try) -> None:
        if node.finalbody:
            first = node.finalbody[0].lineno
            last = max(getattr(s, "end_lineno", s.lineno)
                       for s in node.finalbody)
            self.finally_ranges.append((first, last))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Call) and \
                len(node.targets) == 1:
            kind = _opener(node.value, self.mi)
            t = node.targets[0]
            if kind and isinstance(t, ast.Name):
                self.opened[t.id] = (kind, node.lineno)
        # storing an opened resource anywhere (self.f = x,
        # registry[k] = x, g = x) transfers ownership out of this scope
        if isinstance(node.value, ast.Name) and \
                node.value.id in self.opened:
            for t in node.targets:
                if isinstance(t, (ast.Attribute, ast.Subscript,
                                  ast.Name)):
                    self.escaped.add(node.value.id)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and \
                fn.attr in ("close", "shutdown", "stop", "release"):
            self.closed.setdefault(fn.value.id, []).append(node.lineno)
        # a resource passed to another call transfers ownership
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Name) and arg.id in self.opened:
                self.escaped.add(arg.id)
        # immediate-use leak: open(p).read() — nothing ever closes it
        kind = _opener(node, self.mi)
        if kind and isinstance(getattr(node, "_parent", None),
                               ast.Attribute):
            self.findings.append(Finding(
                "SW201", "error", self.mi.path, node.lineno,
                self.qualname,
                f"{kind} opened and used inline is never closed "
                f"(use a with block)"))
        self.generic_visit(node)

    def _escape_expr(self, value) -> None:
        for n in ast.walk(value) if value is not None else ():
            if isinstance(n, ast.Name) and n.id in self.opened:
                self.escaped.add(n.id)

    def visit_Return(self, node: ast.Return) -> None:
        self._escape_expr(node.value)
        self.generic_visit(node)

    def visit_Yield(self, node: ast.Yield) -> None:
        self._escape_expr(node.value)
        self.generic_visit(node)

    # -- verdicts --

    def finish(self) -> None:
        for var, (kind, line) in self.opened.items():
            if var in self.escaped:
                continue
            closes = self.closed.get(var, [])
            if not closes:
                self.findings.append(Finding(
                    "SW201", "error", self.mi.path, line, self.qualname,
                    f"{kind} '{var}' is never closed in this function "
                    f"(and never escapes it)"))
            elif not any(lo <= ln <= hi for ln in closes
                         for lo, hi in self.finally_ranges):
                self.findings.append(Finding(
                    "SW201", "warning", self.mi.path, line,
                    self.qualname,
                    f"{kind} '{var}' is closed, but not on the "
                    f"exception path (use with/finally)"))


def check_resources(mi: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    for scope, qual in _function_scopes(mi):
        chk = _FuncResourceCheck(mi, qual, findings)
        _annotate_parents(scope)
        for stmt in scope.body:
            chk.visit(stmt)
        chk.finish()
        # SW202: span handles created outside a with / decorator
        for node in _walk_scope(scope):
            if isinstance(node, ast.Call) and _is_span_call(node, mi):
                parent = getattr(node, "_parent", None)
                if isinstance(parent, (ast.withitem, ast.Return)):
                    continue
                if isinstance(parent, ast.Call):  # start_trace(...) arg
                    continue
                findings.append(Finding(
                    "SW202", "warning", mi.path, node.lineno, qual,
                    "tracing span created outside a with-block; it "
                    "will never close (and never records)"))
    return findings


def _annotate_parents(root: ast.AST) -> None:
    for parent in ast.walk(root):
        for child in ast.iter_child_nodes(parent):
            child._parent = parent


def _function_scopes(mi: ModuleInfo):
    """Yield (function node, qualname) for every def, however nested."""
    def rec(node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                yield child, f"{mi.name}:{prefix}{child.name}"
                yield from rec(child, f"{prefix}{child.name}.")
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{prefix}{child.name}.")
            else:
                yield from rec(child, prefix)
    yield from rec(mi.tree, "")


# ---------------------------------------------------------------------------
# SW301 / SW302 — swallowed exceptions
# ---------------------------------------------------------------------------

def _handler_is_silent(handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and \
                isinstance(stmt.value, ast.Constant):
            continue  # bare docstring/ellipsis
        return False
    return True


def _handler_logs_or_raises(handler: ast.ExceptHandler) -> bool:
    """True when the handler surfaces the exception somehow: raises,
    logs, or captures ``as e`` and actually uses the binding (the
    worker-thread idiom ``errors.append(e)`` re-raised elsewhere)."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            try:
                text = ast.unparse(node.func)
            except Exception:  # pragma: no cover
                continue
            if _LOG_CALL_RE.search(text):
                return True
        if handler.name and isinstance(node, ast.Name) and \
                isinstance(node.ctx, ast.Load) and \
                node.id == handler.name:
            return True
    return False


def check_exceptions(mi: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    for scope, qual in _function_scopes(mi):
        in_while: set[int] = set()
        for node in _walk_scope(scope):
            if isinstance(node, ast.While):
                for sub in ast.walk(node):
                    in_while.add(id(sub))
        for node in _walk_scope(scope):
            if not isinstance(node, ast.Try):
                continue
            for h in node.handlers:
                bare = h.type is None
                if bare and not _handler_logs_or_raises(h):
                    findings.append(Finding(
                        "SW302", "error", mi.path, h.lineno, qual,
                        "bare except swallows SystemExit/"
                        "KeyboardInterrupt; catch Exception (and log "
                        "or re-raise)"))
                    continue
                if _handler_is_silent(h):
                    if isinstance(h.type, ast.Name) and h.type.id in (
                            "KeyboardInterrupt", "GeneratorExit",
                            "StopIteration"):
                        continue  # silent pass on these is the idiom
                    fn_name = qual.split(":")[-1].rsplit(".", 1)[-1]
                    hot = bool(_LOOPY_FN_RE.search(fn_name)) or \
                        id(node) in in_while
                    findings.append(Finding(
                        "SW301", "error" if hot else "warning",
                        mi.path, h.lineno, qual,
                        "exception silently swallowed"
                        + (" inside a server/heartbeat loop — a dead "
                           "thread would leave no trace" if hot
                           else " — log it (glog.v is cheap) or "
                           "narrow the except")))
    return findings


# ---------------------------------------------------------------------------
# SW401 / SW402 — metrics label hygiene
# ---------------------------------------------------------------------------

_METRIC_FACTORIES = {"counter", "gauge", "histogram"}


def _unbounded_value(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.JoinedStr):
        return "f-string"
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
        return "%-format"
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in ("str", "repr",
                                                  "format"):
            return f"{fn.id}()"
        if isinstance(fn, ast.Attribute) and fn.attr == "format":
            return ".format()"
    return None


def check_metrics(mi: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    for scope, qual in _function_scopes(mi):
        for node in _walk_scope(scope):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_FACTORIES):
                continue
            recv = ""
            try:
                recv = ast.unparse(node.func.value).lower()
            except Exception:  # pragma: no cover
                pass
            if not ("metric" in recv or recv.endswith("stats")
                    or recv == "m" or recv.endswith("registry")):
                continue
            if node.args and not isinstance(node.args[0], ast.Constant):
                findings.append(Finding(
                    "SW402", "info", mi.path, node.lineno, qual,
                    "dynamic metric name — ensure the set of names is "
                    "bounded"))
            for kw in node.keywords:
                if kw.arg is None:
                    continue  # **labels: opaque here
                how = _unbounded_value(kw.value)
                if how:
                    findings.append(Finding(
                        "SW401", "error", mi.path, kw.value.lineno,
                        qual,
                        f"label {kw.arg}={how} builds an unbounded "
                        f"label set; Prometheus series never expire — "
                        f"use a fixed vocabulary"))
                elif isinstance(kw.value, (ast.Name, ast.Attribute)):
                    findings.append(Finding(
                        "SW402", "info", mi.path, kw.value.lineno,
                        qual,
                        f"label {kw.arg} from a variable — confirm its "
                        f"value set is bounded"))
    return findings


def check_local(mi: ModuleInfo) -> list[Finding]:
    return (check_resources(mi) + check_exceptions(mi)
            + check_metrics(mi))
