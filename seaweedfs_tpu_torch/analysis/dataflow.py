"""Interprocedural value-flow engine for seaweedlint.

Per-function abstract interpretation over the same project call graph
the lock analysis uses (model.call_ref + lockgraph.resolve_call):
every function body is walked with a taint environment mapping local
names to sets of *tokens* —

- ``("pool", line)``   — (a view of) a pooled host buffer acquired
  locally via ``<poolish>.acquire()`` (HostBufferPool protocol);
- ``("param", i)``     — (a view of) the function's i-th parameter
  (``self`` counts, so method summaries compose through receivers).

Tokens flow through assignments, tuple/list displays, subscripts and
slices, numpy view-returning calls (``ascontiguousarray``/``asarray``
*may* return their input — the recycled-slab trap), torch calls that
may return their input or a view of it (``torch.from_numpy``,
``torch.as_tensor``, ``.numpy()``, ``.contiguous()`` — self when the
input is already contiguous, the same edge as ``ascontiguousarray`` —
``.detach()``, ``.view``/``.reshape`` and slicing), view methods
(``reshape``/``ravel``/``T``/...), comprehensions, and — the
interprocedural part — resolved project calls, via per-function
summaries (returns-view-of-param, returns-pooled, releases-param,
param-escapes-to-sink, synchronizes) iterated to a fixpoint so helper
chains compose.

Copies (``.copy()``, ``.flatten()``, ``.clone()``, ``np.array``,
``torch.tensor``, arithmetic) kill taint — that is exactly why a
``flatten()`` in place of ``ascontiguousarray`` reads as safe here.

The walk also records the *events* the rule families consume:

- escapes: a tainted value handed to an async sink (``.put`` /
  ``.submit`` — token-protected submits are marked), returned,
  yielded, or stored on an object;
- releases: ``<poolish>.release(x)`` / ``recycle*(x)`` of a tainted
  value — textual, plus interprocedural via releases-param summaries;
- uses: loads of tainted names (for use-after-release ordering);
- async_hazard: a host buffer written, refilled or released while an
  asynchronous copy from or into it (``non_blocking=True``) may still
  be in flight — no ``.synchronize()`` (an Event's, a stream's,
  ``torch.cuda.synchronize()``, or a resolved project call that makes
  one) between the copy and the write. The buffer is known by its name
  and by its tokens, so a release of the pooled slab a copied view was
  cut from pairs with the copy;
- raw network calls, ``http_request`` routing and ``deadline_scope``
  entry (the SW6xx facts);

Branch sensitivity is deliberately coarse: every event carries a
branch path (tuple of body ids), and rules only pair events whose
branch paths are prefix-comparable — a release in an ``if`` arm never
pairs with a use in the sibling ``else`` arm.

buffer_rules.py / net_rules.py consume this; torch_rules.py is a
separate lexical pass (loops + builds/transfers/cached builders need
no value flow).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Optional

from .lockgraph import Project, resolve_call
from .model import ModuleInfo, call_ref

#: numpy module-level calls whose result may alias argument 0.
#: ``ascontiguousarray``/``asarray`` are the sharp edge: they return
#: the *input itself* when it is already contiguous/an ndarray.
_NP_VIEW_FNS = {
    "ascontiguousarray", "asarray", "asfortranarray", "asanyarray",
    "frombuffer", "reshape", "ravel", "transpose", "squeeze",
    "swapaxes", "moveaxis", "atleast_1d", "atleast_2d", "atleast_3d",
    "broadcast_to", "expand_dims", "split", "array_split", "hsplit",
    "vsplit", "dsplit",
}

#: torch module-level calls whose result may alias argument 0
#: (``torch.tensor`` copies and is not here).
_TORCH_VIEW_FNS = {"from_numpy", "as_tensor", "asarray", "reshape",
                   "squeeze", "unsqueeze", "transpose", "permute",
                   "narrow", "select", "chunk", "split", "unbind",
                   "movedim", "detach"}

#: ndarray / tensor methods returning (possibly) a view of the
#: receiver: ``.numpy()`` shares the tensor's memory, ``.contiguous()``
#: returns the receiver itself when it is already contiguous.
_VIEW_METHODS = {"reshape", "ravel", "view", "transpose", "squeeze",
                 "swapaxes", "diagonal", "numpy", "contiguous",
                 "detach", "view_as", "unsqueeze", "permute", "narrow",
                 "select", "expand", "as_strided", "unflatten",
                 "movedim", "chunk", "split", "unbind"}

#: ndarray / tensor methods guaranteed to copy (or reduce) — taint
#: killers (every method outside _VIEW_METHODS kills; this set is the
#: documentation of the common ones).
_COPY_METHODS = {"copy", "flatten", "tobytes", "astype", "tolist",
                 "sum", "min", "max", "mean", "all", "any", "item",
                 "clone"}

#: Methods that write their receiver in place, besides torch's
#: trailing-underscore ones (``copy_``, ``fill_``, ``zero_``...).
_WRITE_METHODS = {"fill", "itemset", "resize", "sort"}

#: Calls that write their FIRST argument (``f.readinto(buf)``,
#: ``np.copyto(buf, src)``).
_WRITE_ARG0 = {"readinto", "readinto1", "recv_into", "copyto"}

_RELEASE_RE = re.compile(r"(release|recycle)", re.IGNORECASE)
_POOL_RE = re.compile(r"pool", re.IGNORECASE)
_TOKEN_RE = re.compile(r"token", re.IGNORECASE)

_EMPTY: frozenset = frozenset()
_MAX_ROUNDS = 4


def _dotted(e: ast.expr) -> str:
    """Cheap dotted-name text for Name/Attribute chains ('' otherwise)."""
    if isinstance(e, ast.Name):
        return e.id
    if isinstance(e, ast.Attribute):
        base = _dotted(e.value)
        return f"{base}.{e.attr}" if base else e.attr
    return ""


@dataclass
class Summary:
    """Composable interprocedural facts about one function."""

    returns_view_of: frozenset = _EMPTY      # param indices
    returns_pooled: bool = False
    synchronizes: bool = False               # waits for the card
    param_released: frozenset = _EMPTY       # param indices
    #: param index -> (sink, protected)
    param_sinks: dict = field(default_factory=dict)
    raw_net: tuple = ()                      # ((desc, line), ...)
    enters_deadline: bool = False

    def facts(self) -> tuple:
        return (self.returns_view_of, self.returns_pooled,
                self.synchronizes, self.param_released,
                tuple(sorted(self.param_sinks.items())),
                self.raw_net, self.enters_deadline)


@dataclass
class Event:
    kind: str            # escape | release | use | async_hazard
    line: int
    tokens: frozenset
    branch: tuple        # branch path; prefix-comparable events pair
    sink: str = ""       # queue.put | submit | return | yield | store | call
    protected: bool = False
    detail: str = ""


@dataclass
class FlowFunc:
    key: str
    module: str
    path: str
    name: str
    line: int
    params: list
    parent: Optional[str]          # enclosing function key, if nested
    is_method: bool
    node: object = field(repr=False, default=None)
    acquires: list = field(default_factory=list)   # (line, recv text)
    events: list = field(default_factory=list)
    resolved_calls: list = field(default_factory=list)  # (callee, line)
    summary: Summary = field(default_factory=Summary)
    has_project_calls: bool = False


@dataclass
class FlowProject:
    modules: dict
    proj: Project
    flows: dict = field(default_factory=dict)      # key -> FlowFunc


# --------------------------------------------------------------------------
# function discovery — keyed exactly like model.py so lockgraph's
# resolver lands on the matching FlowFunc
# --------------------------------------------------------------------------

def _discover(mi: ModuleInfo, flows: dict) -> None:
    def walk(node, cls: Optional[str], parent: Optional[str]) -> None:
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, ast.ClassDef):
                walk(ch, cls if cls is not None else ch.name, parent)
            elif isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = (f"{mi.name}:{cls}.{ch.name}" if cls
                       else f"{mi.name}:{ch.name}")
                a = ch.args
                params = [p.arg for p in (*a.posonlyargs, *a.args)]
                if key not in flows:
                    flows[key] = FlowFunc(
                        key=key, module=mi.name, path=mi.path,
                        name=ch.name, line=ch.lineno, params=params,
                        parent=parent, is_method=bool(cls), node=ch)
                walk(ch, cls, key)
            else:
                walk(ch, cls, parent)

    walk(mi.tree, None, None)


# --------------------------------------------------------------------------
# per-function abstract interpretation
# --------------------------------------------------------------------------

class _Walker:
    def __init__(self, fp: FlowProject, mi: ModuleInfo, ff: FlowFunc,
                 summaries: dict):
        self.fp = fp
        self.mi = mi
        self.ff = ff
        self.summaries = summaries
        self.env: dict[str, frozenset] = {
            p: frozenset({("param", i)}) for i, p in enumerate(ff.params)}
        self.events: list[Event] = []
        self.acquires: list = []
        self.resolved_calls: list = []
        self.returns_tokens: set = set()
        self.raw_net: list = []
        self.enters_deadline = False
        self.has_project_calls = False
        #: host buffers with an asynchronous copy possibly in flight,
        #: by name and by token -> the copy's (line, branch path)
        self.inflight_names: dict[str, tuple] = {}
        self.inflight_toks: dict[tuple, tuple] = {}
        self.synchronizes = False
        self.pool_names: set[str] = set()   # names bound to *Pool(...)
        self.branch: tuple = ()
        self._branch_seq = 0
        self._mute_use = 0
        self.tokenish = self._token_prepass(ff.node)

    # -- prepass: names ever bound to a *Token(...) constructor --------

    @staticmethod
    def _token_prepass(node) -> set:
        out = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                if _TOKEN_RE.search(_dotted(n.value.func) or ""):
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            out.add(t.id)
        return out

    # -- driver --------------------------------------------------------

    def run(self) -> None:
        for st in self.ff.node.body:
            self.stmt(st)

    def event(self, kind: str, line: int, tokens: frozenset, *,
              sink: str = "", protected: bool = False,
              detail: str = "") -> None:
        self.events.append(Event(kind, line, tokens, self.branch,
                                 sink=sink, protected=protected,
                                 detail=detail))

    def _sub_branch(self):
        self._branch_seq += 1
        return self.branch + (self._branch_seq,)

    def _body(self, stmts, new_branch: bool) -> None:
        prev = self.branch
        if new_branch:
            self.branch = self._sub_branch()
        for st in stmts:
            self.stmt(st)
        self.branch = prev

    # -- statements ----------------------------------------------------

    def stmt(self, st) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # separate scope, analyzed on its own
        if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            if isinstance(st, ast.AugAssign) and \
                    isinstance(st.target, ast.Name):
                # ``buf += x`` updates a tensor / ndarray in place
                self._check_write(st.target, self.env.get(
                    st.target.id, _EMPTY), st.lineno, "written")
            value = getattr(st, "value", None)
            toks = self.expr(value) if value is not None else _EMPTY
            targets = st.targets if isinstance(st, ast.Assign) \
                else [st.target]
            for t in targets:
                self.assign(t, toks)
        elif isinstance(st, ast.Return):
            toks = self.expr(st.value)
            if toks:
                self.returns_tokens |= toks
                self.event("escape", st.lineno, toks, sink="return")
        elif isinstance(st, ast.Expr):
            self.expr(st.value)
        elif isinstance(st, ast.If):
            self.expr(st.test)
            self._body(st.body, True)
            self._body(st.orelse, True)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            it = self.expr(st.iter)
            self.assign(st.target, it)
            self._body(st.body, False)
            self._body(st.orelse, True)
        elif isinstance(st, ast.While):
            self.expr(st.test)
            self._body(st.body, False)
            self._body(st.orelse, True)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                toks = self.expr(item.context_expr)
                if item.optional_vars is not None:
                    self.assign(item.optional_vars, toks)
            self._body(st.body, False)
        elif isinstance(st, ast.Try):
            self._body(st.body, False)
            for h in st.handlers:
                self._body(h.body, True)
            self._body(st.orelse, True)
            self._body(st.finalbody, False)
        elif isinstance(st, (ast.Raise, ast.Assert, ast.Delete)):
            for n in ast.iter_child_nodes(st):
                if isinstance(n, ast.expr):
                    self.expr(n)
        # pass/break/continue/import/global/nonlocal: nothing flows

    def assign(self, target, toks: frozenset) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = toks
            self.inflight_names.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self.assign(el, toks)
        elif isinstance(target, ast.Starred):
            self.assign(target.value, toks)
        elif isinstance(target, (ast.Attribute, ast.Subscript)):
            base = self.expr(target.value)
            if isinstance(target, ast.Subscript):
                self._check_write(target.value, base, target.lineno,
                                  "written")
            if toks and any(t[0] in ("pool", "param") for t in toks):
                self.event("escape", target.lineno, toks, sink="store")

    # -- expressions ---------------------------------------------------

    def expr(self, e) -> frozenset:
        if e is None:
            return _EMPTY
        if isinstance(e, ast.Name):
            toks = self.env.get(e.id, _EMPTY)
            if toks and not self._mute_use and \
                    any(t[0] == "pool" for t in toks):
                self.event("use", e.lineno, toks, detail=e.id)
            return toks
        if isinstance(e, ast.Call):
            return self.call(e)
        if isinstance(e, ast.Attribute):
            base = self.expr(e.value)
            return base if e.attr == "T" else _EMPTY
        if isinstance(e, ast.Subscript):
            base = self.expr(e.value)
            self.expr(e.slice)
            return base
        if isinstance(e, ast.Starred):
            return self.expr(e.value)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            out = _EMPTY
            for el in e.elts:
                out |= self.expr(el)
            return out
        if isinstance(e, ast.Dict):
            out = _EMPTY
            for k in e.keys:
                if k is not None:
                    self.expr(k)
            for v in e.values:
                out |= self.expr(v)
            return out
        if isinstance(e, ast.IfExp):
            self.expr(e.test)
            return self.expr(e.body) | self.expr(e.orelse)
        if isinstance(e, ast.NamedExpr):
            toks = self.expr(e.value)
            self.assign(e.target, toks)
            return toks
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            for g in e.generators:
                self.assign(g.target, self.expr(g.iter))
                for c in g.ifs:
                    self.expr(c)
            if isinstance(e, ast.DictComp):
                self.expr(e.key)
                return self.expr(e.value)
            return self.expr(e.elt)
        if isinstance(e, ast.Await):
            return self.expr(e.value)
        if isinstance(e, (ast.Yield, ast.YieldFrom)):
            toks = self.expr(e.value)
            if toks:
                self.returns_tokens |= toks
                self.event("escape", e.lineno, toks, sink="yield")
            return _EMPTY
        if isinstance(e, ast.Lambda):
            return _EMPTY  # separate scope
        if isinstance(e, (ast.BoolOp, ast.BinOp, ast.UnaryOp,
                          ast.Compare, ast.JoinedStr, ast.FormattedValue,
                          ast.Slice)):
            for n in ast.iter_child_nodes(e):
                if isinstance(n, ast.expr):
                    self.expr(n)
            return _EMPTY
        return _EMPTY

    # -- calls: sources, sinks, numpy algebra, project summaries -------

    def _poolish(self, recv, recv_text: str) -> bool:
        if _POOL_RE.search(recv_text):
            return True
        return isinstance(recv, ast.Name) and recv.id in self.pool_names

    def _protected(self, c: ast.Call) -> bool:
        for v in (*c.args, *(kw.value for kw in c.keywords)):
            if isinstance(v, ast.Call) and \
                    _TOKEN_RE.search(_dotted(v.func) or ""):
                return True
            if isinstance(v, ast.Name) and (
                    _TOKEN_RE.search(v.id) or v.id in self.tokenish):
                return True
        return False

    # -- asynchronous copies (the torch SW503) -----------------------

    @staticmethod
    def _non_blocking(c: ast.Call) -> bool:
        return any(kw.arg == "non_blocking" and not (
            isinstance(kw.value, ast.Constant) and not kw.value.value)
            for kw in c.keywords)

    @staticmethod
    def _root_name(e) -> Optional[str]:
        while isinstance(e, ast.Subscript):
            e = e.value
        return e.id if isinstance(e, ast.Name) else None

    def _start_copy(self, e, toks: frozenset, line: int) -> None:
        """Mark ``e`` (a copy's source or destination) in flight."""
        name = self._root_name(e)
        if name is not None:
            self.inflight_names[name] = (line, self.branch)
        for t in toks:
            if t[0] in ("pool", "param"):
                self.inflight_toks[t] = (line, self.branch)

    def _synchronized(self) -> None:
        self.synchronizes = True
        self.inflight_names.clear()
        self.inflight_toks.clear()

    def _check_write(self, e, toks: frozenset, line: int,
                     what: str) -> None:
        """An async-hazard event when ``e`` (or a buffer it is a view
        of) has a copy in flight on a path that can precede this one
        (a copy in an ``if`` arm never pairs with a write in the
        ``else`` arm); the copy is then reported."""
        def take(table, k):
            line, branch = table[k]
            n = min(len(branch), len(self.branch))
            if branch[:n] != self.branch[:n]:
                return None
            del table[k]
            return line

        name = self._root_name(e)
        hits = [take(self.inflight_names, name)] \
            if name in self.inflight_names else []
        hits += [take(self.inflight_toks, t) for t in toks
                 if t in self.inflight_toks]
        hits = [h for h in hits if h is not None]
        if not hits:
            return
        label = repr(name) if name else "a host buffer"
        self.event("async_hazard", line, toks,
                   detail=f"{label} {what} while the non_blocking copy "
                          f"at line {min(hits)} may still be in flight")

    def _copy_effects(self, c: ast.Call, fn, recv_toks, argtoks,
                      kwtoks) -> None:
        """Asynchronous copies, host syncs and in-place writes."""
        line = c.lineno
        leaf = fn.attr if isinstance(fn, ast.Attribute) else \
            fn.id if isinstance(fn, ast.Name) else ""
        if leaf == "synchronize":
            self._synchronized()
            return
        if _RELEASE_RE.search(leaf):
            for a, toks in zip(c.args, argtoks):
                self._check_write(a, toks, line, "released")
            return
        if leaf in _WRITE_ARG0 and c.args:
            self._check_write(c.args[0], argtoks[0], line, "refilled")
        for kw in c.keywords:
            if kw.arg == "out":
                self._check_write(kw.value, kwtoks["out"], line,
                                  "written")
        if not isinstance(fn, ast.Attribute):
            return
        if self._non_blocking(c) and leaf in ("copy_", "to", "cuda",
                                              "cpu"):
            self._start_copy(fn.value, recv_toks, line)
            if leaf == "copy_" and c.args:
                self._start_copy(c.args[0], argtoks[0], line)
            return
        if leaf in _WRITE_METHODS or (
                leaf.endswith("_") and not leaf.startswith("_")):
            self._check_write(fn.value, recv_toks, line, "written")

    def _check_net(self, c: ast.Call) -> None:
        d = _dotted(c.func)
        leaf = d.rsplit(".", 1)[-1]
        root = d.split(".")[0]
        root_mod = self.mi.imports.get(root, root)
        if leaf == "urlopen":
            src = self.mi.from_imports.get("urlopen", ("", ""))[0]
            if isinstance(c.func, ast.Attribute) or \
                    src.startswith("urllib") or src == "":
                self.raw_net.append((f"{d}()", c.lineno))
        elif leaf in ("HTTPConnection", "HTTPSConnection") and \
                root_mod.startswith("http"):
            self.raw_net.append((f"{d}()", c.lineno))
        elif leaf == "create_connection" and root_mod == "socket":
            self.raw_net.append((f"{d}()", c.lineno))
        elif leaf == "deadline_scope":
            self.enters_deadline = True

    def call(self, c: ast.Call) -> frozenset:
        line = c.lineno
        fn = c.func
        self._check_net(c)

        recv_toks = _EMPTY
        if isinstance(fn, ast.Attribute):
            recv_toks = self.expr(fn.value)
        elif not isinstance(fn, ast.Name):
            self.expr(fn)

        argtoks = [self.expr(a) for a in c.args]
        kwtoks = {kw.arg: self.expr(kw.value) for kw in c.keywords}
        all_args = frozenset().union(*argtoks, *kwtoks.values()) \
            if (argtoks or kwtoks) else _EMPTY
        flowing = frozenset(t for t in all_args
                            if t[0] in ("pool", "param"))
        self._copy_effects(c, fn, recv_toks, argtoks, kwtoks)

        # ---- textual protocol matches (short-circuit resolution) ----
        if isinstance(fn, ast.Attribute):
            attr = fn.attr
            recv_text = _dotted(fn.value)
            if attr == "acquire" and self._poolish(fn.value, recv_text):
                self.acquires.append((line, recv_text))
                return frozenset({("pool", line)})
            if _RELEASE_RE.search(attr) and flowing:
                self._mark_release(line, flowing)
                return _EMPTY
            if attr in ("put", "put_nowait") and flowing:
                self.event("escape", line, flowing, sink="queue.put")
                return _EMPTY
            if attr == "submit" and flowing:
                self.event("escape", line, flowing, sink="submit",
                           protected=self._protected(c))
                return _EMPTY
            root_mod = self.mi.imports.get(recv_text, recv_text)
            if root_mod == "numpy":
                if attr in _NP_VIEW_FNS:
                    return argtoks[0] if argtoks else _EMPTY
                return _EMPTY
            if root_mod == "torch":
                if attr in _TORCH_VIEW_FNS:
                    return argtoks[0] if argtoks else _EMPTY
                return _EMPTY
            if recv_toks:
                if attr in _VIEW_METHODS:
                    return recv_toks
                return _EMPTY
        elif isinstance(fn, ast.Name):
            if fn.id == "memoryview" and argtoks:
                return argtoks[0]
            if _RELEASE_RE.search(fn.id) and flowing:
                self._mark_release(line, flowing)
                return _EMPTY

        # ---- project-call resolution + summary application ----
        ref = call_ref(fn, self.mi)
        callee = self._resolve(ref) if ref is not None else None
        if callee is not None:
            self.has_project_calls = True
            self.resolved_calls.append((callee, line))
            s = self.summaries.get(callee)
            if s is not None:
                return self._apply_summary(c, callee, s, recv_toks,
                                           argtoks, kwtoks, line)
            return _EMPTY
        if flowing:
            # leaves the project with tainted args: weak escape, never
            # flagged alone but visible to future rules
            self.event("escape", line, flowing, sink="call",
                       protected=True, detail=_dotted(fn))
        return _EMPTY

    def _mark_release(self, line: int, toks: frozenset) -> None:
        self.event("release", line, toks)

    def _resolve(self, ref: tuple) -> Optional[str]:
        caller_fi = self.fp.proj.funcs.get(self.ff.key)
        if caller_fi is None:
            return None
        callee = resolve_call(self.fp.proj, self.mi, caller_fi, ref)
        if callee is None:
            return None
        target = self.fp.flows.get(callee)
        if target is None:
            return None
        # scope guard: a plain-name ref must not resolve to a function
        # nested inside an UNRELATED function (model keys nested defs
        # flat, so `sink(...)` in one function could otherwise bind to
        # a different function's local helper)
        if ref[0] == "name" and target.parent is not None:
            anc = self.ff.key
            chain = set()
            while anc is not None:
                chain.add(anc)
                anc = self.fp.flows[anc].parent \
                    if anc in self.fp.flows else None
            if target.parent not in chain:
                return None
        return callee

    def _apply_summary(self, c, callee: str, s: Summary, recv_toks,
                       argtoks, kwtoks, line: int) -> frozenset:
        target = self.fp.flows[callee]
        ref_is_attr = isinstance(c.func, ast.Attribute)
        # bind the receiver as arg 0 for method calls through an
        # attribute (obj.meth(a) -> meth(self=obj, a))
        eff = ([recv_toks] + argtoks) if (target.is_method
                                          and ref_is_attr) else argtoks
        for name, toks in kwtoks.items():
            if name in target.params:
                i = target.params.index(name)
                while len(eff) <= i:
                    eff.append(_EMPTY)
                eff[i] = eff[i] | toks
        short = callee.split(":")[-1]
        out = _EMPTY
        for i in s.returns_view_of:
            if i < len(eff):
                out |= eff[i]
        if s.returns_pooled:
            out |= {("pool", line)}
        if s.synchronizes:
            self._synchronized()
        for i in s.param_released:
            if i < len(eff) and eff[i]:
                self._check_write(None, eff[i], line,
                                  f"released via {short}()")
                self.event("release", line, frozenset(
                    t for t in eff[i] if t[0] in ("pool", "param")),
                    detail=f"via {short}()")
        for i, (sink, prot) in s.param_sinks.items():
            if i < len(eff) and eff[i]:
                toks = frozenset(t for t in eff[i]
                                 if t[0] in ("pool", "param"))
                if toks:
                    self.event("escape", line, toks, sink=sink,
                               protected=prot, detail=f"via {short}()")
        return out


def _summarize(w: _Walker) -> Summary:
    returns_view_of = frozenset(
        t[1] for t in w.returns_tokens if t[0] == "param")
    returns_pooled = any(t[0] == "pool" for t in w.returns_tokens)
    released = set()
    sinks: dict = {}
    for ev in w.events:
        if ev.kind == "release":
            released |= {t[1] for t in ev.tokens if t[0] == "param"}
        elif ev.kind == "escape" and ev.sink in ("queue.put", "submit"):
            for t in ev.tokens:
                if t[0] == "param" and t[1] not in sinks:
                    sinks[t[1]] = (ev.sink, ev.protected)
    return Summary(returns_view_of=returns_view_of,
                   returns_pooled=returns_pooled,
                   synchronizes=w.synchronizes,
                   param_released=frozenset(released),
                   param_sinks=sinks,
                   raw_net=tuple(w.raw_net),
                   enters_deadline=w.enters_deadline)


def build_flows(modules: dict[str, ModuleInfo],
                proj: Optional[Project] = None) -> FlowProject:
    """Walk every function to a summary fixpoint; the returned
    FlowProject carries final per-function events for the rules."""
    if proj is None:
        proj = Project(modules)
    fp = FlowProject(modules=modules, proj=proj)
    for mi in modules.values():
        _discover(mi, fp.flows)

    summaries: dict[str, Summary] = {k: Summary() for k in fp.flows}
    active = list(fp.flows.values())
    for _round in range(_MAX_ROUNDS):
        changed = False
        next_active = []
        for ff in active:
            mi = fp.modules[ff.module]
            w = _Walker(fp, mi, ff, summaries)
            # pool-constructor name prepass (cheap, one walk)
            for n in ast.walk(ff.node):
                if isinstance(n, ast.Assign) and \
                        isinstance(n.value, ast.Call) and \
                        "BufferPool" in (_dotted(n.value.func) or ""):
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            w.pool_names.add(t.id)
            w.run()
            ff.acquires = w.acquires
            ff.events = w.events
            ff.resolved_calls = w.resolved_calls
            ff.has_project_calls = w.has_project_calls
            new = _summarize(w)
            if new.facts() != summaries[ff.key].facts():
                summaries[ff.key] = new
                changed = True
            if w.has_project_calls:
                next_active.append(ff)
        if not changed:
            break
        # later rounds only re-walk functions whose results can change
        active = next_active
    for ff in fp.flows.values():
        ff.summary = summaries[ff.key]
    return fp
