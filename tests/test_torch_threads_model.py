"""The port's thread-role model (``analysis/threads.py``) against the JAX
package's, on the cases of ``tests/test_threads_model.py``: entrypoint
enumeration per spawning idiom, role propagation to fixpoint, the
guaranteed-lockset meet and the lifecycle happens-before closure. Each
case runs once per package, and ``model_of`` builds both packages'
models and holds their roles, locksets and accesses equal."""

import dataclasses
import textwrap

import pytest

from torch_lint import PKGS, module
from torch_teardown import collect_jax_garbage  # noqa: F401


@pytest.fixture(autouse=True, params=PKGS)
def pkg(request):
    """Every case runs once per package; ``model_of`` builds both and
    holds them equal, then answers for this one."""
    global PKG
    PKG = request.param
    yield PKG


PKG = "port"


def _canon(x):
    """Dataclasses, dicts and sets in a form two models compare by."""
    if dataclasses.is_dataclass(x):
        return tuple(_canon(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return sorted(((_canon(k), _canon(v)) for k, v in x.items()),
                      key=repr)
    if isinstance(x, (set, frozenset)):
        return sorted(map(_canon, x), key=repr)
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return x


def model_of(files_or_src, path="pkg/mod.py"):
    if isinstance(files_or_src, str):
        files_or_src = {path: files_or_src}
    models = {}
    for p_ in PKGS:
        modules = {}
        for p, s in files_or_src.items():
            name = p[:-3].replace("/", ".")
            modules[name] = module(p_, "model").collect_module(
                name, p, textwrap.dedent(s))
        proj = module(p_, "lockgraph").Project(modules)
        models[p_] = module(p_, "threads").build_thread_model(
            module(p_, "dataflow").build_flows(modules, proj))
    assert _canon(models["jax"]) == _canon(models["port"])
    return models[PKG]


def steady_roles(*a, **kw):
    return module(PKG, "threads").steady_roles(*a, **kw)


# ---------------------------------------------------------------------------
# entrypoint enumeration: one spawn idiom at a time
# ---------------------------------------------------------------------------

def test_thread_name_literal_becomes_role():
    m = model_of("""
        import threading

        class Pipe:
            def __init__(self):
                self._t = threading.Thread(target=self._run,
                                           name="ec-pipe-read")
                self._t.start()

            def _run(self):
                self.batches = 1
    """)
    (sp,) = m.spawns
    assert sp.role == "ec-pipe-read"
    assert sp.kind == "thread"
    assert not sp.multi
    assert "ec-pipe-read" in m.roles_of("pkg.mod:Pipe._run")


def test_thread_without_name_uses_target_function():
    m = model_of("""
        import threading

        class P:
            def go(self):
                threading.Thread(target=self._loop).start()

            def _loop(self):
                pass
    """)
    (sp,) = m.spawns
    assert sp.role == "thread:P._loop"


def test_timer_spawn():
    m = model_of("""
        import threading

        class Ticker:
            def arm(self):
                self._t = threading.Timer(5.0, self._tick)
                self._t.start()

            def _tick(self):
                self.ticks = 1
    """)
    (sp,) = m.spawns
    assert sp.kind == "timer"
    assert sp.role == "timer:Ticker._tick"
    assert "timer:Ticker._tick" in m.roles_of("pkg.mod:Ticker._tick")


def test_executor_submit_is_multi_instance():
    m = model_of("""
        class Pool:
            def kick(self, ex):
                ex.submit(self._work)

            def _work(self):
                self.done = 1
    """)
    (sp,) = m.spawns
    assert sp.kind == "submit"
    assert sp.multi
    assert sp.role in m.multi_roles
    assert sp.role in m.roles_of("pkg.mod:Pool._work")


def test_ingress_verb_methods_get_multi_ingress_role():
    m = model_of("""
        class Handler:
            def do_GET(self):
                self.hits = 1
    """)
    assert "ingress" in m.roles_of("pkg.mod:Handler.do_GET")
    assert "ingress" in m.multi_roles


def test_servicer_methods_get_rpc_role():
    m = model_of("""
        class VolumeServicer:
            def Heartbeat(self, request):
                self.beats = 1

            def _helper(self):
                pass
    """)
    assert "rpc" in m.roles_of("pkg.mod:VolumeServicer.Heartbeat")
    assert "rpc" in m.multi_roles
    # private methods are not servicer entrypoints by themselves
    assert "rpc" not in m.roles_of("pkg.mod:VolumeServicer._helper")


def test_loop_spawn_is_multi_instance():
    m = model_of("""
        import threading

        class Pool:
            def start(self):
                for i in range(4):
                    threading.Thread(target=self._worker,
                                     name="pool-worker").start()

            def _worker(self):
                self.n = 1
    """)
    (sp,) = m.spawns
    assert sp.multi
    assert "pool-worker" in m.multi_roles


# ---------------------------------------------------------------------------
# propagation fixpoint
# ---------------------------------------------------------------------------

def test_roles_propagate_transitively_to_fixpoint():
    m = model_of("""
        import threading

        class P:
            def __init__(self):
                threading.Thread(target=self._run, name="runner").start()

            def _run(self):
                self._step()

            def _step(self):
                self._leaf()

            def _leaf(self):
                self.x = 1
    """)
    for fn in ("_run", "_step", "_leaf"):
        assert "runner" in m.roles_of(f"pkg.mod:P.{fn}"), fn


def test_unreached_function_defaults_to_main():
    m = model_of("""
        def standalone():
            pass
    """)
    assert m.roles_of("pkg.mod:standalone") == frozenset({"main"})


def test_function_reached_from_spawn_and_main_has_both_roles():
    m = model_of("""
        import threading

        class P:
            def __init__(self):
                threading.Thread(target=self._run, name="bg").start()

            def _run(self):
                self._shared()

            def poke(self):
                self._shared()

            def _shared(self):
                self.x = 1
    """)
    roles = m.roles_of("pkg.mod:P._shared")
    assert "bg" in roles and "main" in roles


# ---------------------------------------------------------------------------
# guaranteed locksets (meet over call sites)
# ---------------------------------------------------------------------------

def test_guaranteed_lockset_when_every_caller_holds_the_lock():
    m = model_of("""
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def a(self):
                with self._lock:
                    self._inner()

            def b(self):
                with self._lock:
                    self._inner()

            def _inner(self):
                self.v = 1
    """)
    assert m.guarded.get("pkg.mod:C._inner")
    # the access inside _inner inherits the guaranteed lockset
    (acc,) = [a for a in m.accesses if a.attr == "v"]
    assert m.effective_lockset(acc)


def test_one_unlocked_caller_empties_the_meet():
    m = model_of("""
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def a(self):
                with self._lock:
                    self._inner()

            def b(self):
                self._inner()

            def _inner(self):
                self.v = 1
    """)
    assert not m.guarded.get("pkg.mod:C._inner")


# ---------------------------------------------------------------------------
# lifecycle closure + pre-publication locals
# ---------------------------------------------------------------------------

def test_init_only_helper_joins_lifecycle_closure():
    m = model_of("""
        class Node:
            def __init__(self):
                self._load()

            def _load(self):
                self.state = {}
    """)
    assert "pkg.mod:Node._load" in m.lifecycle
    (acc,) = [a for a in m.accesses if a.attr == "state"]
    assert steady_roles(m, acc) == frozenset()


def test_helper_also_called_from_steady_state_stays_out():
    m = model_of("""
        class Node:
            def __init__(self):
                self._load()

            def refresh(self):
                self._load()

            def _load(self):
                self.state = {}
    """)
    assert "pkg.mod:Node._load" not in m.lifecycle


def test_init_writes_are_not_steady_state():
    m = model_of("""
        class C:
            def __init__(self):
                self.a = 1
    """)
    (acc,) = [a for a in m.accesses if a.attr == "a"]
    assert acc.in_init
    assert steady_roles(m, acc) == frozenset()


def test_fresh_local_writes_are_pre_publication():
    m = model_of("""
        class Box:
            pass

        def make():
            b = Box()
            b.payload = 1
            return b
    """)
    (acc,) = [a for a in m.accesses if a.attr == "payload"]
    assert acc.in_init  # pre-publication window counts as init-phase
    assert steady_roles(m, acc) == frozenset()


# ---------------------------------------------------------------------------
# shared-state access capture + containers + publish points
# ---------------------------------------------------------------------------

def test_access_kinds_and_held_locks_recorded():
    m = model_of("""
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
                self.items = {}

            def bump(self):
                with self._lock:
                    self.n += 1

            def put(self, k):
                self.items[k] = 1
    """)
    (rmw,) = [a for a in m.accesses
              if a.attr == "n" and a.kind == "rmw"]
    assert rmw.held, "lexically held lock must be recorded"
    (mut,) = [a for a in m.accesses if a.kind == "mutate"]
    assert mut.attr == "items"
    assert m.containers[("pkg.mod:C", "items")] == "dict"


def test_publish_point_recorded_in_init():
    m = model_of("""
        import threading

        class S:
            def __init__(self):
                self.a = 1
                self._t = threading.Thread(target=self._run)
                self._t.start()
                self.b = 2

            def _run(self):
                pass
    """)
    assert "pkg.mod:S.__init__" in m.publishes
    line, desc = m.publishes["pkg.mod:S.__init__"]
    assert "start" in desc
