"""Thread-role model: which threads can execute which function.

The lock graph (lockgraph.py) knows what locks a function holds; the
dataflow engine (dataflow.py) knows what values flow where. Neither
answers the question every new concurrency PR raises: *which threads
actually run this code?* This module closes that gap with a role
model built from the codebase's own spawning idioms:

- ``threading.Thread(target=f)`` / ``threading.Timer(t, f)`` — the
  pipeline stage threads (pipe.py/writeback.py), daemon pushers and
  reap loops, heartbeat tickers;
- worker-pool ``executor.submit(f, ...)`` where ``f`` resolves to a
  project function;
- ``IngressHTTPServer`` handler dispatch — ``do_GET``-style verb
  methods run on ingress worker-pool threads, many at once.

Each spawn site yields a *role* (named from the ``Thread(name=...)``
literal when present, else the target function). A role is
*multi-instance* when the spawn site sits in a loop or comprehension,
comes from an executor submit, or is ingress dispatch — meaning two
threads of the SAME role can race each other. Roles propagate over
the resolved project call graph (lockgraph.resolve_call) to a
fixpoint, so every function ends up with the set of thread roles that
can reach it; functions reachable from no spawn site carry the
implicit ``main`` role.

On top of the roles the model computes, per function, the *guaranteed
lockset*: the set of locks held on EVERY resolved path into the
function (intersection over call sites of locks-held-at-call, seeded
empty at thread entrypoints and call-graph roots). Combined with the
locally-held locks at an attribute access this gives the Eraser-style
candidate lockset the SW8xx rules (race_rules.py) intersect.

Finally the model records every *shared-state access*: writes,
read-modify-writes, check-then-set sequences, and container mutations
on ``self`` attributes and on locals/params whose project class is
inferable (annotations, ``x = SomeClass(...)`` constructor calls,
inherited through nested-function scopes — the ``st.read_seconds +=``
idiom of the pipeline stage closures), plus writes to ``global``
module state. race_rules.py turns (roles x locksets x accesses) into
SW801-SW804.

Runtime complement: util/racecheck.py observes the same race class
dynamically (per-(object, attr) lockset state machine) under
``SEAWEEDFS_TORCH_RACECHECK=1``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Optional

from .dataflow import FlowProject, _dotted
from .lockgraph import Project, resolve_call
from .model import (ClassInfo, ModuleInfo, call_ref, looks_locky,
                    resolve_lock_ref)

_MAX_ROUNDS = 16

#: Method names that mutate a dict/list/set receiver in place.
_MUTATORS = {"append", "extend", "insert", "remove", "add", "discard",
             "update", "setdefault", "pop", "popitem", "clear",
             "appendleft", "extendleft"}

#: __init__ right-hand sides that type an attribute as a plain
#: (unsynchronized) container. queue.Queue / deque are internally
#: locked and deliberately absent.
_CONTAINER_CTORS = {"dict": "dict", "list": "list", "set": "set",
                    "defaultdict": "dict", "OrderedDict": "dict",
                    "Counter": "dict"}

_VERB_RE = re.compile(r"^do_[A-Z]+$")

#: Functions whose writes are construction/teardown, not steady-state
#: concurrency: roles seen here never count toward "written from >=2
#: roles". __init__ is the happens-before-publication window; close/
#: stop/join/shutdown run after the worker threads are quiesced.
_LIFECYCLE_RE = re.compile(
    r"^(__init__|__enter__|__exit__|close|stop|shutdown|join|"
    r"uninstall|reset)$")


@dataclass
class Spawn:
    """One thread-creation site."""
    role: str                 # role name ("ec-pipe-read", "thread:_run")
    target: Optional[str]     # resolved function key, if resolvable
    line: int
    path: str
    func: str                 # spawning function key
    multi: bool               # spawned in a loop / pool / ingress
    kind: str                 # "thread" | "timer" | "submit" | "ingress"


@dataclass
class Access:
    """One shared-state access site."""
    owner: str                # "mod:Class" or "mod:<globals>"
    attr: str
    func: str                 # enclosing function key
    path: str
    line: int
    held: frozenset           # lock ids held lexically at the access
    kind: str                 # "write" | "rmw" | "mutate"
    compound: bool = False    # check-then-set shape
    in_init: bool = False     # inside the owner's __init__
    detail: str = ""          # e.g. the mutating call text


@dataclass
class ThreadModel:
    spawns: list = field(default_factory=list)          # [Spawn]
    #: synchronous project calls: (caller key, callee key, held locks)
    #: — lock ids from the SAME resolver as Access.held, so the
    #: guaranteed-lockset meet and the per-access locksets agree
    calls: list = field(default_factory=list)
    #: function key -> roles that can reach it (never empty after build)
    roles: dict = field(default_factory=dict)
    #: role names where >1 thread instance can exist at once
    multi_roles: set = field(default_factory=set)
    #: function key -> locks held on EVERY path into the function
    guarded: dict = field(default_factory=dict)
    accesses: list = field(default_factory=list)        # [Access]
    #: (owner, attr) -> container kind ("dict"|"list"|"set")
    containers: dict = field(default_factory=dict)
    #: "mod:Class" -> union of roles over the class's methods
    class_roles: dict = field(default_factory=dict)
    #: __init__ key -> (publish line, publish description)
    publishes: dict = field(default_factory=dict)
    #: function keys whose writes are construction/teardown-phase:
    #: lifecycle-named methods plus helpers reachable ONLY from them
    lifecycle: set = field(default_factory=set)

    def roles_of(self, key: str) -> frozenset:
        return self.roles.get(key, frozenset({"main"}))

    def effective_lockset(self, acc: Access) -> frozenset:
        return acc.held | self.guarded.get(acc.func, frozenset())

    def owner_roles(self, owner: str) -> frozenset:
        """Roles that can touch instances of ``owner``: its methods'
        roles plus the roles of every recorded external access."""
        out = set(self.class_roles.get(owner, ()))
        for a in self.accesses:
            if a.owner == owner:
                out |= self.roles_of(a.func)
        return frozenset(out)


# --------------------------------------------------------------------------
# helpers: project-class resolution for annotations / constructor calls
# --------------------------------------------------------------------------

def _class_key(expr: ast.expr, mi: ModuleInfo,
               project_classes: set) -> Optional[str]:
    """Map a constructor callee / annotation to 'mod:Class' when it
    names a class of this project."""
    if isinstance(expr, ast.Subscript):       # Optional[C] / list[C]
        return _class_key(expr.slice, mi, project_classes)
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        name = expr.value.strip("'\"")
        if name in mi.classes:
            key = f"{mi.name}:{name}"
            return key if key in project_classes else None
        tgt = mi.from_imports.get(name)
        if tgt:
            key = f"{tgt[0]}:{tgt[1]}"
            return key if key in project_classes else None
        return None
    if isinstance(expr, ast.Name):
        if expr.id in mi.classes:
            key = f"{mi.name}:{expr.id}"
            return key if key in project_classes else None
        tgt = mi.from_imports.get(expr.id)
        if tgt:
            key = f"{tgt[0]}:{tgt[1]}"
            return key if key in project_classes else None
        return None
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name):
        mod = mi.imports.get(expr.value.id)
        if mod:
            key = f"{mod}:{expr.attr}"
            return key if key in project_classes else None
    return None


def _threading_ctor(c: ast.Call, mi: ModuleInfo) -> Optional[str]:
    """'threading.Thread(...)' / 'Thread(...)' -> "Thread"|"Timer"."""
    fn = c.func
    name = None
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and mi.imports.get(fn.value.id, fn.value.id) == "threading":
        name = fn.attr
    elif isinstance(fn, ast.Name):
        tgt = mi.from_imports.get(fn.id)
        if tgt and tgt[0] == "threading":
            name = tgt[1]
    return name if name in ("Thread", "Timer") else None


# --------------------------------------------------------------------------
# per-function walker: spawns + shared-state accesses + publish points
# --------------------------------------------------------------------------

class _FuncWalker:
    def __init__(self, model: ThreadModel, proj: Project,
                 mi: ModuleInfo, ff, cls: Optional[ClassInfo],
                 env: dict, project_classes: set):
        self.model = model
        self.proj = proj
        self.mi = mi
        self.ff = ff            # dataflow.FlowFunc (has .node/.key/...)
        self.cls = cls
        self.cls_key = None
        if cls is not None:
            self.cls_key = f"{mi.name}:{cls.name}"
        self.env = env          # name -> "mod:Class"
        self.project_classes = project_classes
        self.held: list[str] = []
        self.loop_depth = 0
        self.globals_declared: set[str] = set()
        self.is_init = ff.name == "__init__" and ff.is_method
        #: local/self-attr names bound to a Thread/Timer in this body
        self.threadish: set[str] = set()
        #: locals freshly constructed here (``x = C(...)``) that have
        #: not yet escaped — writes to them are pre-publication
        self.fresh: set[str] = set()
        self.publish: Optional[tuple] = None   # (line, description)

    # -- entry ---------------------------------------------------------

    def run(self) -> None:
        for st in self.ff.node.body:
            self.stmt(st)

    # -- shared plumbing ----------------------------------------------

    def _record(self, owner: str, attr: str, line: int, kind: str,
                compound: bool = False, detail: str = "",
                via_self: bool = False,
                pre_pub: bool = False) -> None:
        self.model.accesses.append(Access(
            owner=owner, attr=attr, func=self.ff.key, path=self.ff.path,
            line=line, held=frozenset(self.held), kind=kind,
            compound=compound,
            in_init=(self.is_init and via_self) or pre_pub,
            detail=detail))

    def _owner_of(self, recv: ast.expr) -> tuple[Optional[str], bool]:
        """(owner class key, receiver-is-self) for an attribute
        receiver expression, or (None, False) when untypable."""
        if isinstance(recv, ast.Name):
            if recv.id == "self" and self.cls_key is not None:
                return self.cls_key, True
            owner = self.env.get(recv.id)
            return owner, False
        return None, False

    def _lock_ref(self, expr: ast.expr) -> Optional[str]:
        """Like model.resolve_lock_ref, plus typed receivers: the
        vacuum module's ``with vol._lock:`` (``vol`` a Volume param)
        must yield the SAME lock id as ``with self._lock:`` inside
        Volume methods, or the lockset intersection can never agree."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id != "self":
            ck = self.env.get(expr.value.id)
            if ck is not None and looks_locky(expr.attr):
                mod, cname = ck.split(":", 1)
                omi = self.proj.modules.get(mod)
                oci = omi.classes.get(cname) if omi else None
                if oci is not None:
                    d = oci.lock_defs.get(expr.attr)
                    if d is not None:
                        return d.alias_of or d.lock_id
                return f"{mod}.{cname}.{expr.attr}"
        return resolve_lock_ref(expr, self.mi, self.cls, self.ff.key)

    def _attr_target(self, t: ast.expr) -> Optional[tuple]:
        """(owner, attr, via_self, pre_pub) for an attribute store
        target; pre_pub marks writes to a local constructed in this
        function that has not yet escaped (``err = XError(...);
        err.code = ...`` before the raise)."""
        if isinstance(t, ast.Attribute):
            owner, via_self = self._owner_of(t.value)
            if owner is not None:
                pre_pub = isinstance(t.value, ast.Name) and \
                    t.value.id in self.fresh
                return owner, t.attr, via_self, pre_pub
        return None

    # -- statements ----------------------------------------------------

    def stmt(self, st) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # separate scope: walked as its own FlowFunc
        if isinstance(st, ast.Global):
            self.globals_declared |= set(st.names)
            return
        if isinstance(st, (ast.Assign, ast.AnnAssign)):
            value = st.value
            targets = st.targets if isinstance(st, ast.Assign) \
                else [st.target]
            for t in targets:
                self._store(t, value, st.lineno)
            if value is not None:
                self._expr(value)
            return
        if isinstance(st, ast.AugAssign):
            hit = self._attr_target(st.target)
            if hit is not None:
                owner, attr, via_self, pre_pub = hit
                self._record(owner, attr, st.lineno, "rmw",
                             via_self=via_self, pre_pub=pre_pub)
            elif isinstance(st.target, ast.Name) and \
                    st.target.id in self.globals_declared:
                self._record(f"{self.mi.name}:<globals>", st.target.id,
                             st.lineno, "rmw")
            elif isinstance(st.target, ast.Subscript):
                self._subscript_store(st.target, st.lineno)
            self._expr(st.value)
            return
        if isinstance(st, ast.Delete):
            for t in st.targets:
                if isinstance(t, ast.Subscript):
                    self._subscript_store(t, st.lineno, op="del")
            return
        if isinstance(st, ast.If):
            self._check_then_set(st)
            self._expr(st.test)
            for s in st.body:
                self.stmt(s)
            for s in st.orelse:
                self.stmt(s)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(st.iter)
            self.loop_depth += 1
            for s in st.body:
                self.stmt(s)
            self.loop_depth -= 1
            for s in st.orelse:
                self.stmt(s)
            return
        if isinstance(st, ast.While):
            self._expr(st.test)
            self.loop_depth += 1
            for s in st.body:
                self.stmt(s)
            self.loop_depth -= 1
            for s in st.orelse:
                self.stmt(s)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in st.items:
                lid = self._lock_ref(item.context_expr)
                if lid is not None:
                    acquired.append(lid)
                self._expr(item.context_expr)
            self.held.extend(acquired)
            for s in st.body:
                self.stmt(s)
            del self.held[len(self.held) - len(acquired):]
            return
        if isinstance(st, ast.Import) or isinstance(st, ast.ImportFrom):
            return
        if isinstance(st, ast.Try):
            for s in st.body:
                self.stmt(s)
            for h in st.handlers:
                for s in h.body:
                    self.stmt(s)
            for s in st.orelse:
                self.stmt(s)
            for s in st.finalbody:
                self.stmt(s)
            return
        if isinstance(st, ast.Expr):
            self._expr(st.value)
            return
        if isinstance(st, ast.Match):
            self._expr(st.subject)
            for case in st.cases:
                for s in case.body:
                    self.stmt(s)
            return
        if isinstance(st, (ast.Return, ast.Raise, ast.Assert)):
            for n in ast.iter_child_nodes(st):
                if isinstance(n, ast.expr):
                    self._expr(n)
            return
        # pass / break / continue / import: nothing to see

    def _store(self, t: ast.expr, value, line: int) -> None:
        hit = self._attr_target(t)
        if hit is not None:
            owner, attr, via_self, pre_pub = hit
            self._record(owner, attr, line, "write", via_self=via_self,
                         pre_pub=pre_pub)
            if via_self and self.is_init and value is not None:
                self._note_container(attr, value)
            if value is not None and isinstance(value, ast.Call) and \
                    _threading_ctor(value, self.mi) and via_self:
                self.threadish.add(f"self.{attr}")
            return
        if isinstance(t, ast.Name):
            if t.id in self.globals_declared:
                self._record(f"{self.mi.name}:<globals>", t.id, line,
                             "write")
            if value is not None:
                # local typing: x = SomeProjectClass(...) / Thread(...)
                ck = self._value_class(value)
                if ck is not None:
                    self.env[t.id] = ck
                    # fresh ONLY for a bare constructor call: the
                    # object cannot be shared until it escapes
                    if isinstance(value, ast.Call):
                        self.fresh.add(t.id)
                    else:
                        self.fresh.discard(t.id)
                else:
                    self.fresh.discard(t.id)
                if isinstance(value, ast.Call) and \
                        _threading_ctor(value, self.mi):
                    self.threadish.add(t.id)
            return
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._store(el, None, line)
            return
        if isinstance(t, ast.Subscript):
            self._subscript_store(t, line)

    def _value_class(self, value: ast.expr) -> Optional[str]:
        if isinstance(value, ast.Call):
            return _class_key(value.func, self.mi, self.project_classes)
        if isinstance(value, ast.BoolOp):   # st = stats or PipeStats()
            for v in value.values:
                ck = self._value_class(v)
                if ck is not None:
                    return ck
        return None

    def _note_container(self, attr: str, value: ast.expr) -> None:
        kind = None
        if isinstance(value, ast.Dict) or \
                isinstance(value, ast.DictComp):
            kind = "dict"
        elif isinstance(value, (ast.List, ast.ListComp)):
            kind = "list"
        elif isinstance(value, (ast.Set, ast.SetComp)):
            kind = "set"
        elif isinstance(value, ast.Call):
            leaf = _dotted(value.func).rsplit(".", 1)[-1]
            kind = _CONTAINER_CTORS.get(leaf)
        if kind is not None and self.cls_key is not None:
            self.model.containers[(self.cls_key, attr)] = kind

    def _subscript_store(self, t: ast.Subscript, line: int,
                         op: str = "[]=") -> None:
        if isinstance(t.value, ast.Attribute):
            owner, via_self = self._owner_of(t.value.value)
            if owner is not None:
                self._record(owner, t.value.attr, line, "mutate",
                             detail=op, via_self=via_self)

    def _check_then_set(self, st: ast.If) -> None:
        """``if self.x is None: self.x = ...`` — the compound
        check-then-set SW802 cares about."""
        read: set[tuple] = set()
        for n in ast.walk(st.test):
            if isinstance(n, ast.Attribute) and \
                    isinstance(n.ctx, ast.Load):
                owner, via_self = self._owner_of(n.value)
                if owner is not None:
                    read.add((owner, n.attr, via_self))
        if not read:
            return
        for s in st.body:
            if not isinstance(s, (ast.Assign, ast.AugAssign)):
                continue
            targets = s.targets if isinstance(s, ast.Assign) \
                else [s.target]
            for t in targets:
                hit = self._attr_target(t)
                if hit is None:
                    continue
                owner, attr, via_self, pre_pub = hit
                if (owner, attr, via_self) in read:
                    self._record(owner, attr, s.lineno, "write",
                                 compound=True, via_self=via_self,
                                 pre_pub=pre_pub)

    # -- expressions: spawns, mutating calls, publish points -----------

    def _expr(self, e: ast.expr) -> None:
        if self.fresh:
            # conservative escape: any further appearance of a fresh
            # local in an expression (call arg, raise, return value,
            # even a method call on it) ends its pre-publication window
            for n in ast.walk(e):
                if isinstance(n, ast.Name):
                    self.fresh.discard(n.id)
        for n in ast.walk(e):
            if isinstance(n, ast.Call):
                self._call(n)
            elif isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                                ast.GeneratorExp)):
                # spawns inside a comprehension are multi-instance
                for inner in ast.walk(n):
                    if isinstance(inner, ast.Call):
                        self._call(inner, in_comp=True)

    def _call(self, c: ast.Call, in_comp: bool = False) -> None:
        fn = c.func
        ctor = _threading_ctor(c, self.mi)
        if ctor is not None:
            self._spawn_from_ctor(c, ctor, in_comp)
            return
        # the call itself runs synchronously on this thread — record
        # it with the locks held HERE for role + lockset propagation
        callee = self._resolve_target(fn)
        if callee is not None:
            self.model.calls.append(
                (self.ff.key, callee, frozenset(self.held)))
        if not isinstance(fn, ast.Attribute):
            return
        attr = fn.attr
        # chained threading.Thread(...).start()
        if attr == "start" and isinstance(fn.value, ast.Call) and \
                _threading_ctor(fn.value, self.mi):
            self._publish(c.lineno, "thread started")
            return
        if attr == "start":
            recv = _dotted(fn.value)
            if recv in self.threadish:
                self._publish(c.lineno, f"{recv}.start()")
            return
        if attr in ("put", "put_nowait", "append", "register"):
            if any(isinstance(a, ast.Name) and a.id == "self"
                   for a in c.args):
                self._publish(c.lineno, f"self handed to .{attr}()")
        if attr == "submit" and c.args:
            tkey = self._resolve_target(c.args[0])
            if tkey is not None:
                short = tkey.split(":")[-1]
                self.model.spawns.append(Spawn(
                    role=f"worker:{short}", target=tkey, line=c.lineno,
                    path=self.ff.path, func=self.ff.key, multi=True,
                    kind="submit"))
            return
        if attr in _MUTATORS:
            owner_expr = fn.value
            if isinstance(owner_expr, ast.Attribute):
                owner, via_self = self._owner_of(owner_expr.value)
                if owner is not None:
                    self._record(owner, owner_expr.attr, c.lineno,
                                 "mutate", detail=f".{attr}()",
                                 via_self=via_self)

    def _publish(self, line: int, desc: str) -> None:
        if self.is_init and self.publish is None:
            self.publish = (line, desc)
            self.model.publishes[self.ff.key] = self.publish

    def _spawn_from_ctor(self, c: ast.Call, ctor: str,
                         in_comp: bool) -> None:
        target = None
        name_lit = None
        if ctor == "Thread":
            for kw in c.keywords:
                if kw.arg == "target":
                    target = self._resolve_target(kw.value)
                elif kw.arg == "name" and \
                        isinstance(kw.value, ast.Constant) and \
                        isinstance(kw.value.value, str):
                    name_lit = kw.value.value
        else:  # Timer(interval, fn)
            if len(c.args) >= 2:
                target = self._resolve_target(c.args[1])
            for kw in c.keywords:
                if kw.arg == "function":
                    target = self._resolve_target(kw.value)
        if target is None:
            return   # lambda / dynamic target: nothing to propagate to
        short = target.split(":")[-1]
        role = name_lit or (f"timer:{short}" if ctor == "Timer"
                            else f"thread:{short}")
        multi = in_comp or self.loop_depth > 0
        self.model.spawns.append(Spawn(
            role=role, target=target, line=c.lineno, path=self.ff.path,
            func=self.ff.key, multi=multi,
            kind="timer" if ctor == "Timer" else "thread"))

    def _resolve_target(self, expr: ast.expr) -> Optional[str]:
        ref = call_ref(expr, self.mi)
        if ref is None:
            return None
        if ref[0] == "unique":
            # the sole-method-of-that-name heuristic over-resolves
            # stdlib calls (handler.finish() is not the linter's
            # visitor) — a wrong edge here leaks a thread role into
            # an unrelated class, so roles only follow hard edges
            return None
        fi = self.proj.funcs.get(self.ff.key)
        if fi is None:
            return None
        return resolve_call(self.proj, self.mi, fi, ref)


# --------------------------------------------------------------------------
# model construction
# --------------------------------------------------------------------------

def _typing_envs(fp: FlowProject, project_classes: set) -> dict:
    """Per-function name->class env seeded from parameter annotations,
    inherited down nested-function chains (closures see the enclosing
    function's locals — the pipeline's ``reader``/``writer`` stage
    closures type ``st``/``controller`` this way)."""
    envs: dict[str, dict] = {}

    def env_for(key: str) -> dict:
        if key in envs:
            return envs[key]
        ff = fp.flows[key]
        base: dict = {}
        if ff.parent is not None and ff.parent in fp.flows:
            base.update(env_for(ff.parent))
        mi = fp.modules[ff.module]
        args = ff.node.args
        for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            if a.annotation is not None:
                ck = _class_key(a.annotation, mi, project_classes)
                if ck is not None:
                    base[a.arg] = ck
        envs[key] = base
        return base

    for key in fp.flows:
        env_for(key)
    return envs


def build_thread_model(fp: FlowProject) -> ThreadModel:
    """Build the full model from an already-built FlowProject."""
    proj = fp.proj
    model = ThreadModel()
    project_classes = {
        f"{mi.name}:{cname}"
        for mi in fp.modules.values() for cname in mi.classes}
    envs = _typing_envs(fp, project_classes)

    # ---- pass 1: walk every function body ----
    for key, ff in fp.flows.items():
        mi = fp.modules[ff.module]
        cls = None
        tail = key.rsplit(":", 1)[1]
        if ff.is_method and "." in tail:
            cls = mi.classes.get(tail.split(".")[0])
        w = _FuncWalker(model, proj, mi, ff, cls,
                        dict(envs.get(key, {})), project_classes)
        w.run()

    # ---- pass 2: entry roles ----
    entries: dict[str, set] = {}
    for sp in model.spawns:
        if sp.target is None:
            continue
        entries.setdefault(sp.target, set()).add(sp.role)
        if sp.multi:
            model.multi_roles.add(sp.role)
    for key, ff in fp.flows.items():
        if not ff.is_method:
            continue
        if _VERB_RE.match(ff.name):
            # do_GET-style verb methods: ingress worker-pool dispatch
            entries.setdefault(key, set()).add("ingress")
            model.multi_roles.add("ingress")
            continue
        tail = key.rsplit(":", 1)[1]
        cname = tail.split(".")[0]
        if "Servicer" in cname and not ff.name.startswith("_"):
            # grpc servicer methods run on the server's worker threads
            entries.setdefault(key, set()).add("rpc")
            model.multi_roles.add("rpc")

    # ---- pass 3: role propagation over the resolved call graph ----
    # (call facts come from the walker — pass 1 — so held-lock ids
    # match the per-access ids exactly)
    calls: dict[str, list] = {}
    for caller, callee, held in model.calls:
        calls.setdefault(caller, []).append((callee, 0, held))
    callees_of = {k: [c for c, _l, _h in v] for k, v in calls.items()}
    called = {c for cs in callees_of.values() for c in cs}
    roles: dict[str, set] = {}
    for key in fp.flows:
        roles[key] = set(entries.get(key, ()))
        if key not in called and key not in entries:
            roles[key].add("main")
    for _ in range(_MAX_ROUNDS):
        changed = False
        for key, cs in callees_of.items():
            if key not in roles:
                continue
            src = roles[key]
            if not src:
                continue
            for c in cs:
                tgt = roles.setdefault(c, set())
                if not src <= tgt:
                    tgt |= src
                    changed = True
        if not changed:
            break
    for key in fp.flows:
        if not roles.get(key):
            roles[key] = {"main"}
    model.roles = {k: frozenset(v) for k, v in roles.items()}

    # ---- pass 4a: lifecycle closure ----
    # a private helper called ONLY from lifecycle methods (RaftNode
    # __init__ -> _load) runs in the same happens-before window; its
    # writes must not count as steady-state concurrency, and its
    # call sites must not weaken the guaranteed-lockset meet below.
    callers_of: dict[str, set] = {}
    for key, cs in callees_of.items():
        for c in cs:
            callers_of.setdefault(c, set()).add(key)
    lifecycle = {k for k in fp.flows
                 if _LIFECYCLE_RE.match(
                     k.rsplit(":", 1)[1].split(".")[-1])}
    for _ in range(_MAX_ROUNDS):
        grew = False
        for key in fp.flows:
            if key in lifecycle or key in entries:
                continue
            cs = callers_of.get(key)
            if cs and all(c in lifecycle for c in cs):
                lifecycle.add(key)
                grew = True
        if not grew:
            break
    model.lifecycle = lifecycle - set(entries)

    # ---- pass 4b: guaranteed locksets (meet over call sites) ----
    # entries and roots run lock-free; every other function holds
    # exactly the locks held on ALL resolved paths into it.
    guarded: dict[str, Optional[frozenset]] = {}
    for key in fp.flows:
        if key in entries or key not in called:
            guarded[key] = frozenset()
    for _ in range(_MAX_ROUNDS):
        changed = False
        for key, cs in calls.items():
            if key in model.lifecycle:
                continue   # happens-before callers don't constrain
            g = guarded.get(key)
            if g is None:
                continue
            for callee, _line, held in cs:
                if callee == key:
                    continue
                contrib = g | held
                cur = guarded.get(callee)
                new = contrib if cur is None else (cur & contrib)
                if new != cur:
                    guarded[callee] = new
                    changed = True
        if not changed:
            break
    model.guarded = {k: v for k, v in guarded.items() if v}

    # ---- pass 5: class roles ----
    for key in fp.flows:
        mod, tail = key.rsplit(":", 1)
        if "." in tail:
            ck = f"{mod}:{tail.split('.')[0]}"
            model.class_roles.setdefault(ck, set()).update(
                model.roles[key])
    return model


def steady_roles(model: ThreadModel, acc: Access) -> frozenset:
    """Roles that can perform ``acc`` during steady-state operation:
    the enclosing function's roles, minus nothing — unless the
    function is a lifecycle method (init/teardown) or a helper
    reachable only from one, whose accesses happen before publication
    or after quiesce."""
    if acc.in_init or acc.func in model.lifecycle:
        return frozenset()
    name = acc.func.rsplit(":", 1)[1].split(".")[-1]
    if _LIFECYCLE_RE.match(name):
        return frozenset()
    return model.roles_of(acc.func)
