"""SW7xx — torch dispatch hazards (lexical pass).

The counterpart of the JAX package's SW70x, for the idioms the port
has instead of ``jax.jit`` / ``device_put`` / ``static_argnums``: kernel
builds and compiles, host<->card copies and host syncs, and builders
cached behind ``functools.lru_cache`` (``ops/rs_cuda.py``,
``ops/rs_torch.py``, ``parallel/mesh.py``, ``ops/gf256.py``). The rules
fire only on torch calls (resolved through the module's imports) or,
for SW702's method forms, in a module that imports torch:

- SW701 (warning): a compile or build inside a for/while loop or a
  comprehension — ``torch.compile``, ``torch.jit.script|trace``,
  ``torch.utils.cpp_extension.load|load_inline``, and CUDA-graph
  capture (``torch.cuda.graph``, ``torch.cuda.CUDAGraph``,
  ``make_graphed_callables``): a recompile or rebuild per iteration;
  hoist it or cache the built object.
- SW702 (warning): a synchronous transfer or host sync inside a loop —
  ``.to(<device>)`` / ``.cuda()`` / ``.copy_()`` without
  ``non_blocking=True``, ``.item()``, ``.tolist()``, ``.cpu()`` and
  ``torch.cuda.synchronize()``: each iteration stalls the host on the
  card; batch the reads, or copy asynchronously and sync once after
  the loop.
- SW703 (error): an unhashable literal (list/dict/set/comprehension)
  passed to a project function decorated with ``functools.lru_cache``
  or ``functools.cache`` — the cache hashes every argument, so the call
  raises TypeError.
- SW704 (warning): a loop that places loop-invariant data with a device
  argument that tracks the loop variable — one ``.to(f"cuda:{i}")``
  (or ``.cuda(i)``) per device; ``torch.cuda.comm.broadcast`` places
  one tensor on every device in one call. When BOTH the data and the
  device track the loop, the loop moves distinct blocks to distinct
  devices and neither SW702 nor SW704 fires.
"""

from __future__ import annotations

import ast
from typing import Optional

from .dataflow import _dotted
from .findings import Finding
from .lockgraph import Project, resolve_call
from .model import FuncInfo, ModuleInfo, call_ref

_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.SetComp,
               ast.DictComp, ast.GeneratorExp)

#: (module, leaf) pairs of torch's compile / build / capture calls.
_BUILDS = {("torch", "compile"), ("torch.jit", "script"),
           ("torch.jit", "trace"), ("torch.utils.cpp_extension", "load"),
           ("torch.utils.cpp_extension", "load_inline"),
           ("torch.cuda", "graph"), ("torch.cuda", "CUDAGraph"),
           ("torch.cuda", "make_graphed_callables")}

_CACHES = {("functools", "lru_cache"), ("functools", "cache")}

#: torch dtype names: ``.to(torch.uint8)`` is a cast, not a transfer.
_DTYPES = {"uint8", "int8", "int16", "int32", "int64", "float16",
           "float32", "float64", "bfloat16", "bool", "half", "float",
           "double", "long", "int", "short", "complex64", "complex128"}

_SYNC_METHODS = {"item", "tolist", "cpu"}


def _names(node: Optional[ast.AST]) -> set[str]:
    """Every ``Name`` identifier referenced under ``node``."""
    if node is None:
        return set()
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _qualified(e: ast.expr, mi: ModuleInfo) -> tuple[str, str]:
    """-> (module the callee comes from, leaf name), through the
    module's imports: ``cpp_extension.load`` with ``from torch.utils
    import cpp_extension`` -> ("torch.utils.cpp_extension", "load")."""
    d = _dotted(e)
    if not d:
        return "", ""
    if "." not in d:
        src = mi.from_imports.get(d)
        return (src[0], src[1]) if src else ("", d)
    head, leaf = d.rsplit(".", 1)
    root, _, rest = head.partition(".")
    if root in mi.from_imports:
        mod, name = mi.from_imports[root]
        base = f"{mod}.{name}"
    else:
        base = mi.imports.get(root, root)
    return (f"{base}.{rest}" if rest else base), leaf


def _imports_torch(mi: ModuleInfo) -> bool:
    return any(m == "torch" or m.startswith("torch.")
               for m in (*mi.imports.values(),
                         *(src for src, _ in mi.from_imports.values())))


def _non_blocking(c: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and not (
        isinstance(kw.value, ast.Constant) and not kw.value.value)
        for kw in c.keywords)


def _device_arg(c: ast.Call, mi: ModuleInfo) -> Optional[ast.expr]:
    """The device a ``.to(...)`` / ``.cuda(...)`` call moves to, or
    None when it is a dtype cast (or names no device)."""
    leaf = c.func.attr
    dev = next((kw.value for kw in c.keywords if kw.arg == "device"),
               None)
    if dev is not None:
        return dev
    if not c.args:
        return ast.Constant("cuda") if leaf == "cuda" else None
    a = c.args[0]
    if leaf == "cuda":
        return a
    if isinstance(a, ast.Attribute):
        mod, name = _qualified(a, mi)
        if (mod == "torch" and name in _DTYPES) or \
                name.endswith("dtype"):
            return None
    if isinstance(a, ast.Name) and a.id.endswith("dtype"):
        return None
    return a


def _cached_functions(modules: dict[str, ModuleInfo]) -> set[str]:
    """Keys (as model.py keys them) of functions decorated with
    ``functools.lru_cache`` / ``functools.cache``."""
    out = set()
    for mi in modules.values():
        def walk(node, cls):
            for ch in ast.iter_child_nodes(node):
                if isinstance(ch, ast.ClassDef):
                    walk(ch, cls if cls is not None else ch.name)
                elif isinstance(ch, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    for d in ch.decorator_list:
                        fn = d.func if isinstance(d, ast.Call) else d
                        if _qualified(fn, mi) in _CACHES:
                            out.add(f"{mi.name}:{cls}.{ch.name}" if cls
                                    else f"{mi.name}:{ch.name}")
                    walk(ch, cls)
                else:
                    walk(ch, cls)

        walk(mi.tree, None)
    return out


class _Scope(ast.NodeVisitor):
    """One function (or module) scope: loop depth + loop variables."""

    def __init__(self, mi: ModuleInfo, qualname: str, proj: Project,
                 cached: set, findings: list):
        self.mi = mi
        self.qualname = qualname
        self.proj = proj
        self.cached = cached
        self.findings = findings
        self.torch_module = _imports_torch(mi)
        self.caller = proj.funcs.get(qualname) or FuncInfo(
            key=qualname, module=mi.name, line=0, name="<module>")
        self.loop_depth = 0
        #: one set of bound loop-target names per enclosing loop
        self.loop_vars: list[set[str]] = []

    # -- nested scopes are walked separately --
    def visit_FunctionDef(self, node):  # noqa: N802
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _loop(self, node, targets=frozenset()):
        self.loop_depth += 1
        self.loop_vars.append(set(targets))
        for ch in node.body:
            self.visit(ch)
        self.loop_vars.pop()
        self.loop_depth -= 1

    def visit_For(self, node):  # noqa: N802
        self.visit(node.iter)
        self._loop(node, _names(node.target))
        for ch in node.orelse:
            self.visit(ch)

    visit_AsyncFor = visit_For

    def visit_While(self, node):  # noqa: N802
        self.visit(node.test)
        self._loop(node)
        for ch in node.orelse:
            self.visit(ch)

    def _comp(self, node):
        self.loop_depth += 1
        self.loop_vars.append(
            set().union(*(_names(g.target) for g in node.generators)))
        self.generic_visit(node)
        self.loop_vars.pop()
        self.loop_depth -= 1

    visit_ListComp = _comp
    visit_SetComp = _comp
    visit_DictComp = _comp
    visit_GeneratorExp = _comp

    def visit_Assign(self, node):  # noqa: N802
        # a name bound in the loop from the loop variable tracks it too
        # (``view = t[lo:hi]`` with ``lo, hi`` from the loop's cell)
        self.generic_visit(node)
        if self.loop_vars and \
                _names(node.value) & set().union(*self.loop_vars):
            for t in node.targets:
                self.loop_vars[-1] |= _names(t)

    def _add(self, rule, severity, line, message):
        self.findings.append(Finding(rule, severity, self.mi.path, line,
                                     self.qualname, message))

    def visit_Call(self, node):  # noqa: N802
        if self.loop_depth > 0:
            self._check_loop_call(node)
        self._check_cached_call(node)
        self.generic_visit(node)

    def _check_loop_call(self, node: ast.Call):
        mod, leaf = _qualified(node.func, self.mi)
        if (mod, leaf) in _BUILDS:
            self._add("SW701", "warning", node.lineno,
                      f"{mod}.{leaf}(...) inside a loop — a compile, "
                      f"build or graph capture per iteration; hoist it "
                      f"or cache the built object (see ops/rs_cuda.py "
                      f"library())")
            return
        if (mod, leaf) == ("torch.cuda", "synchronize"):
            self._sync_in_loop(node, "torch.cuda.synchronize()")
            return
        if not self.torch_module or \
                not isinstance(node.func, ast.Attribute):
            return
        if leaf in ("to", "cuda"):
            dev = _device_arg(node, self.mi)
            if dev is not None:
                self._check_placement(node, dev)
        elif leaf == "copy_" and not _non_blocking(node):
            self._sync_in_loop(node, ".copy_() without non_blocking=True")
        elif leaf in _SYNC_METHODS and not node.args and \
                not _non_blocking(node):
            self._sync_in_loop(node, f".{leaf}()")

    def _sync_in_loop(self, node: ast.Call, what: str):
        self._add("SW702", "warning", node.lineno,
                  f"{what} inside a loop — a synchronous transfer or "
                  f"host sync per iteration stalls the host on the card; "
                  f"copy with non_blocking=True into pinned memory and "
                  f"synchronize once after the loop, or batch the reads")

    def _check_placement(self, node: ast.Call, dev: ast.expr):
        bound = set().union(*self.loop_vars)
        data_dep = bool(_names(node.func.value) & bound)
        dev_dep = bool(_names(dev) & bound)
        if dev_dep and not data_dep:
            self._add("SW704", "warning", node.lineno,
                      "a loop-invariant tensor placed on a "
                      "per-iteration device — one "
                      "torch.cuda.comm.broadcast(tensor, devices) "
                      "places it on every device in one call")
        elif dev_dep and data_dep:
            # distinct data onto distinct devices each iteration: a
            # legitimate per-shard transfer, not a dispatch hazard
            return
        elif not _non_blocking(node):
            leaf = node.func.attr
            self._sync_in_loop(node, f".{leaf}(<device>) without "
                                     f"non_blocking=True")

    def _check_cached_call(self, node: ast.Call):
        ref = call_ref(node.func, self.mi)
        if ref is None or ref[0] not in ("name", "alias", "self"):
            return
        callee = resolve_call(self.proj, self.mi, self.caller, ref)
        if callee not in self.cached:
            return
        short = callee.split(":")[-1]
        for i, a in enumerate(node.args):
            if isinstance(a, _UNHASHABLE):
                self._flag_703(a.lineno, short, f"positional arg {i}")
        for kw in node.keywords:
            if isinstance(kw.value, _UNHASHABLE):
                self._flag_703(kw.value.lineno, short,
                               f"keyword {kw.arg!r}")

    def _flag_703(self, line, callee, what):
        self._add("SW703", "error", line,
                  f"unhashable argument ({what}) passed to {callee}(), "
                  f"which functools.lru_cache/cache wraps — every "
                  f"argument of a cached function must be hashable "
                  f"(TypeError at the call); pass a tuple or frozenset")


def check_torch(modules: dict[str, ModuleInfo],
                proj: Optional[Project] = None) -> list[Finding]:
    if proj is None:
        proj = Project(modules)
    cached = _cached_functions(modules)
    findings: list[Finding] = []
    for mi in modules.values():
        scopes: list[tuple] = [(mi.tree, f"{mi.name}:<module>")]

        def walk(n, cls):
            for ch in ast.iter_child_nodes(n):
                if isinstance(ch, ast.ClassDef):
                    walk(ch, cls if cls is not None else ch.name)
                elif isinstance(ch, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    qual = (f"{mi.name}:{cls}.{ch.name}" if cls
                            else f"{mi.name}:{ch.name}")
                    scopes.append((ch, qual))
                    walk(ch, cls)
                else:
                    walk(ch, cls)

        walk(mi.tree, None)
        for node, qual in scopes:
            sc = _Scope(mi, qual, proj, cached, findings)
            for st in node.body:
                sc.visit(st)
    return findings
