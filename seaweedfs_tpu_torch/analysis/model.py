"""Per-module AST model: locks, calls, blocking ops, attribute types.

One ``ModuleCollector`` pass per file produces a ``ModuleInfo``; the
cross-module lock graph (lockgraph.py) and the local rules
(local_rules.py) both consume it, so every file is parsed exactly once.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Optional

#: Attribute / variable names that denote a lock even without a visible
#: ``threading.Lock()`` assignment (inherited, dict-of-locks, ...).
_LOCKY_RE = re.compile(r"(^|_)(r?lock|locks|mu|mutex|cond)(_|s$|$|\[)",
                       re.IGNORECASE)

_SOCKET_BLOCKING_ATTRS = {"connect", "connect_ex", "accept", "recv",
                          "recvfrom", "recv_into", "sendall", "sendto",
                          "makefile", "getresponse"}
_SUBPROCESS_FNS = {"run", "Popen", "call", "check_call", "check_output"}
_OS_FILE_FNS = {"fsync", "replace", "rename", "truncate"}
_CAMEL_RE = re.compile(r"^[A-Z][A-Za-z0-9]*$")


def looks_locky(name: str) -> bool:
    return bool(_LOCKY_RE.search(name))


@dataclass
class LockDef:
    lock_id: str        # "mod.Class.attr" / "mod.name"
    kind: str           # "Lock" | "RLock" | "Condition" | "unknown"
    line: int
    alias_of: Optional[str] = None   # Condition(self._lock) -> that lock


@dataclass
class FuncInfo:
    key: str            # "mod:Class.meth" / "mod:func"
    module: str
    line: int
    name: str
    #: lock_id -> first with-statement line acquiring it in this body
    acquires: dict[str, int] = field(default_factory=dict)
    #: direct nesting: (outer_id, inner_id, line of inner with)
    nest_edges: list[tuple[str, str, int]] = field(default_factory=list)
    #: (ref, line, held lock ids at the call, with_lines of held locks)
    calls: list[tuple[tuple, int, tuple[str, ...], tuple[int, ...]]] = \
        field(default_factory=list)
    #: (category, description, line, held ids, with_lines of held locks)
    blocking: list[tuple[str, str, int, tuple[str, ...],
                         tuple[int, ...]]] = field(default_factory=list)


@dataclass
class ClassInfo:
    name: str
    line: int
    lock_defs: dict[str, LockDef] = field(default_factory=dict)  # by attr
    #: self.attr = SomeProjectClass(...)  ->  "mod:SomeProjectClass"
    attr_types: dict[str, str] = field(default_factory=dict)
    methods: dict[str, FuncInfo] = field(default_factory=dict)


@dataclass
class ModuleInfo:
    name: str                     # dotted module name
    path: str                     # repo-relative path
    tree: ast.Module
    #: import alias -> dotted module ("np" -> "numpy")
    imports: dict[str, str] = field(default_factory=dict)
    #: from-imported name -> (module, original name)
    from_imports: dict[str, tuple[str, str]] = field(default_factory=dict)
    module_locks: dict[str, LockDef] = field(default_factory=dict)
    classes: dict[str, ClassInfo] = field(default_factory=dict)
    functions: dict[str, FuncInfo] = field(default_factory=dict)


def _resolve_relative(module: str, target: Optional[str],
                      level: int) -> str:
    """Resolve ``from ..util import x`` against ``module``'s package."""
    if level == 0:
        return target or ""
    parts = module.split(".")
    # the module itself is not a package; level 1 = its own package
    base = parts[:-level] if level <= len(parts) else []
    if target:
        base = base + target.split(".")
    return ".".join(base)


def _lock_ctor(node: ast.expr,
               mi: ModuleInfo) -> Optional[tuple[str, ast.Call]]:
    """'threading.Lock()' / 'Lock()' -> ("Lock", call node)."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = None
    if isinstance(fn, ast.Attribute) and \
            isinstance(fn.value, ast.Name) and \
            mi.imports.get(fn.value.id, fn.value.id) == "threading":
        name = fn.attr
    elif isinstance(fn, ast.Name):
        tgt = mi.from_imports.get(fn.id)
        if tgt and tgt[0] == "threading":
            name = tgt[1]
    if name in ("Lock", "RLock", "Condition"):
        return name, node
    return None


class ModuleCollector(ast.NodeVisitor):
    """Single-pass collector for one module."""

    def __init__(self, name: str, path: str, tree: ast.Module):
        self.mi = ModuleInfo(name=name, path=path, tree=tree)
        self._class: Optional[ClassInfo] = None
        self._func: Optional[FuncInfo] = None
        #: (lock_id, with_line) stack while visiting a function body
        self._held: list[tuple[str, int]] = []

    def collect(self) -> ModuleInfo:
        self.visit(self.mi.tree)
        return self.mi

    # ---- imports ----

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.mi.imports[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = _resolve_relative(self.mi.name, node.module,
                                node.level or 0)
        for a in node.names:
            if a.name == "*":
                continue
            self.mi.from_imports[a.asname or a.name] = (mod, a.name)
            # "from ..util import tracing" imports a MODULE; record it
            # in imports too so "tracing.span" resolves.
            self.mi.imports.setdefault(a.asname or a.name,
                                       f"{mod}.{a.name}" if mod
                                       else a.name)

    # ---- scopes ----

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self._class = self._class, ClassInfo(node.name, node.lineno)
        self.mi.classes[node.name] = self._class
        self.generic_visit(node)
        self._class = prev

    def _visit_func(self, node) -> None:
        ci = self._class
        key = (f"{self.mi.name}:{ci.name}.{node.name}" if ci
               else f"{self.mi.name}:{node.name}")
        prev_f, prev_h = self._func, self._held
        self._func = FuncInfo(key=key, module=self.mi.name,
                              line=node.lineno, name=node.name)
        self._held = []
        if ci and node.name not in ci.methods:
            ci.methods[node.name] = self._func
        elif not ci and node.name not in self.mi.functions:
            self.mi.functions[node.name] = self._func
        self.generic_visit(node)
        self._func, self._held = prev_f, prev_h

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # ---- lock definitions ----

    def _register_lock(self, target: ast.expr, value: ast.expr,
                       line: int) -> None:
        ctor = _lock_ctor(value, self.mi)
        if ctor is None:
            # self.attr = ProjectClass(...) -> attribute type
            if (self._class is not None
                    and isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                    and isinstance(value, ast.Call)):
                cls_key = self._resolve_class(value.func)
                if cls_key:
                    self._class.attr_types[target.attr] = cls_key
            return
        kind, call = ctor
        alias = None
        if kind == "Condition" and call.args:
            alias = self._lock_ref(call.args[0])
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self" and self._class is not None:
            lid = f"{self.mi.name}.{self._class.name}.{target.attr}"
            self._class.lock_defs[target.attr] = LockDef(
                lid, kind, line, alias)
        elif isinstance(target, ast.Name) and self._func is None:
            lid = f"{self.mi.name}.{target.id}"
            self.mi.module_locks[target.id] = LockDef(lid, kind, line,
                                                      alias)

    def _resolve_class(self, fn: ast.expr) -> Optional[str]:
        """Map a constructor callee to 'module:Class' if it names a
        class imported from (or defined in) this project."""
        if isinstance(fn, ast.Name):
            if fn.id in self.mi.classes:
                return f"{self.mi.name}:{fn.id}"
            tgt = self.mi.from_imports.get(fn.id)
            if tgt and tgt[1][:1].isupper():
                return f"{tgt[0]}:{tgt[1]}"
        elif isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name):
            mod = self.mi.imports.get(fn.value.id)
            if mod and fn.attr[:1].isupper():
                return f"{mod}:{fn.attr}"
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._register_lock(t, node.value, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._register_lock(node.target, node.value, node.lineno)
        self.generic_visit(node)

    # ---- lock references / acquisition ----

    def _lock_ref(self, expr: ast.expr) -> Optional[str]:
        return resolve_lock_ref(
            expr, self.mi, self._class,
            self._func.key if self._func else None)

    def lock_kind(self, lock_id: str) -> str:
        for defs in (self.mi.module_locks,
                     *(c.lock_defs for c in self.mi.classes.values())):
            for d in defs.values():
                if d.lock_id == lock_id:
                    return d.kind
        return "unknown"

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            lid = self._lock_ref(item.context_expr)
            if lid is None:
                continue
            f = self._func
            if f is not None:
                f.acquires.setdefault(lid, node.lineno)
                held_ids = [h for h, _ in self._held] + \
                    [a for a, _ in acquired]
                for outer in dict.fromkeys(held_ids):
                    if outer != lid or self.lock_kind(lid) == "Lock":
                        f.nest_edges.append((outer, lid, node.lineno))
            acquired.append((lid, node.lineno))
        self._held.extend(acquired)
        self.generic_visit(node)
        del self._held[len(self._held) - len(acquired):]

    visit_AsyncWith = visit_With

    # ---- calls: blocking classification + call graph refs ----

    def _callee_text(self, fn: ast.expr) -> str:
        try:
            return ast.unparse(fn)
        except Exception:  # pragma: no cover — unparse is total on exprs
            return ""

    def _blocking_category(self, node: ast.Call) -> Optional[tuple[str,
                                                                   str]]:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            recv = self._callee_text(fn.value)
            root = recv.split(".")[0].split("(")[0]
            root_mod = self.mi.imports.get(root, "")
            if fn.attr == "sleep" and (root_mod == "time"
                                       or root == "time"):
                return "sleep", f"{recv}.sleep()"
            if fn.attr in _SOCKET_BLOCKING_ATTRS and "sock" in recv.lower():
                return "socket", f"{recv}.{fn.attr}()"
            if fn.attr == "urlopen" or root_mod.startswith("urllib"):
                return "network", f"{recv}.{fn.attr}()"
            if root_mod == "requests":
                return "network", f"requests.{fn.attr}()"
            if root_mod == "subprocess" and fn.attr in _SUBPROCESS_FNS:
                return "subprocess", f"subprocess.{fn.attr}()"
            if root_mod == "os" and fn.attr in _OS_FILE_FNS:
                return "file", f"os.{fn.attr}()"
            if _CAMEL_RE.match(fn.attr) and "stub" in recv.lower():
                return "rpc", f"{recv}.{fn.attr}()"
        elif isinstance(fn, ast.Name):
            if fn.id == "open":
                return "file", "open()"
            if fn.id == "sleep" and \
                    self.mi.from_imports.get("sleep", ("", ""))[0] == \
                    "time":
                return "sleep", "sleep()"
            if fn.id == "urlopen":
                return "network", "urlopen()"
        return None

    def _call_ref(self, fn: ast.expr) -> Optional[tuple]:
        return call_ref(fn, self.mi)

    def visit_Call(self, node: ast.Call) -> None:
        f = self._func
        if f is not None:
            held = tuple(dict.fromkeys(h for h, _ in self._held))
            wlines = tuple(ln for _, ln in self._held)
            cat = self._blocking_category(node)
            if cat is not None:
                f.blocking.append((cat[0], cat[1], node.lineno, held,
                                   wlines))
            ref = self._call_ref(node.func)
            if ref is not None:
                f.calls.append((ref, node.lineno, held, wlines))
        self.generic_visit(node)


def resolve_lock_ref(expr: ast.expr, mi: ModuleInfo,
                     cls: Optional[ClassInfo],
                     func_key: Optional[str]) -> Optional[str]:
    """Resolve a with-context expression to a lock id, or None.

    Shared by the collector above and the thread-role model
    (threads.py): both layers must agree on what lock a ``with``
    statement holds so the static SW8xx locksets line up with the
    SW1xx lock graph.
    """
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name):
        base, attr = expr.value.id, expr.attr
        if base == "self" and cls is not None:
            d = cls.lock_defs.get(attr)
            if d is not None:
                return d.alias_of or d.lock_id
            if looks_locky(attr):
                return f"{mi.name}.{cls.name}.{attr}"
            return None
        mod = mi.imports.get(base)
        if mod and looks_locky(attr):
            return f"{mod}.{attr}"
        if looks_locky(attr):  # other_obj._lock — name-scoped
            return f"{mi.name}.<{base}>.{attr}"
        return None
    if isinstance(expr, ast.Name):
        d = mi.module_locks.get(expr.id)
        if d is not None:
            return d.alias_of or d.lock_id
        tgt = mi.from_imports.get(expr.id)
        if tgt and looks_locky(expr.id):
            return f"{tgt[0]}.{tgt[1]}"
        if looks_locky(expr.id):
            scope = func_key or mi.name
            return f"{scope}.{expr.id}"
        return None
    if isinstance(expr, ast.Subscript):
        text = ast.unparse(expr.value)
        if looks_locky(text):
            scope = func_key or mi.name
            return f"{scope}.{text}[]"
    return None


def call_ref(fn: ast.expr, mi: ModuleInfo) -> Optional[tuple]:
    """Classify a call's callee expression into a resolvable reference.

    Shared by the lock graph and the value-flow engine (dataflow.py) so
    both layers agree on what a call site *is* before either resolves
    it against the project call graph.
    """
    if isinstance(fn, ast.Name):
        return ("name", fn.id)
    if isinstance(fn, ast.Attribute):
        v = fn.value
        if isinstance(v, ast.Name):
            if v.id == "self":
                return ("self", fn.attr)
            if v.id in mi.imports:
                return ("alias", v.id, fn.attr)
            return ("unique", fn.attr)
        if isinstance(v, ast.Attribute) and \
                isinstance(v.value, ast.Name) and v.value.id == "self":
            return ("selfattr", v.attr, fn.attr)
        return ("unique", fn.attr)
    return None


def collect_module(name: str, path: str, source: str) -> ModuleInfo:
    tree = ast.parse(source, filename=path)
    return ModuleCollector(name, path, tree).collect()
