"""The port's own lint rules, which have no JAX counterpart to be held
against: the torch dispatch hazards SW701-SW704 (``analysis/torch_rules.py``)
and the torch form of SW503 (a host buffer written, refilled or released
while an asynchronous copy from or into it may be in flight), each with
a positive and a negative case. ``ckpt/store.py``'s ``_place_block``
reads as clean as written, and is flagged once its loop of
``ev.synchronize()`` is cut from a copy of its source text."""

import textwrap
from pathlib import Path

from seaweedfs_tpu_torch.analysis import analyze_sources

REPO = Path(__file__).resolve().parent.parent
STORE = "seaweedfs_tpu_torch/ckpt/store.py"
SYNC_LOOP = """            for ev in events:
                ev.synchronize()
"""


def lint(src, path="pkg/mod.py"):
    return analyze_sources({path: textwrap.dedent(src)})


def only(findings, rule):
    return [f for f in findings if f.rule == rule]


# ---------------------------------------------------------------------------
# SW701 — compile / build / graph capture inside a loop
# ---------------------------------------------------------------------------

def test_sw701_cpp_extension_build_per_item_is_flagged():
    fs = only(lint("""
        from torch.utils.cpp_extension import load_inline

        def build_all(sources):
            return [load_inline("k", src) for src in sources]
    """), "SW701")
    assert len(fs) == 1 and fs[0].severity == "warning"
    assert "torch.utils.cpp_extension.load_inline" in fs[0].message


def test_sw701_script_and_graph_capture_in_loops_are_flagged():
    fs = only(lint("""
        import torch

        def each(fns, n):
            out = []
            for fn in fns:
                out.append(torch.jit.script(fn))
            while n:
                g = torch.cuda.CUDAGraph()
                n -= 1
            return out
    """), "SW701")
    assert [f.line for f in fs] == [7, 9]


def test_sw701_build_once_outside_the_loop_is_clean():
    assert not only(lint("""
        import torch

        def run(fn, xs):
            g = torch.compile(fn)
            return [g(x) for x in xs]
    """), "SW701")


# ---------------------------------------------------------------------------
# SW702 — synchronous transfer or host sync inside a loop
# ---------------------------------------------------------------------------

def test_sw702_item_and_synchronize_per_iteration_are_flagged():
    fs = only(lint("""
        import torch

        def total(ys):
            n = 0
            for y in ys:
                n += y.sum().item()
                torch.cuda.synchronize()
            return n
    """), "SW702")
    assert [f.line for f in fs] == [7, 8]
    assert all(f.severity == "warning" for f in fs)


def test_sw702_blocking_copy_flagged_non_blocking_clean():
    src = """
        import torch

        def stage(dst, chunks):
            for c in chunks:
                dst.copy_(c)
    """
    assert len(only(lint(src), "SW702")) == 1
    assert not only(lint(src.replace("dst.copy_(c)",
                                     "dst.copy_(c, non_blocking=True)")),
                    "SW702")


def test_sw702_dtype_cast_and_torchless_module_are_clean():
    # .to(<dtype>) moves nothing; .tolist() in a module that never
    # imports torch is a list of a numpy array
    assert not only(lint("""
        import torch

        def widen(xs):
            return [x.to(torch.int64) for x in xs]
    """), "SW702")
    assert not only(lint("""
        import numpy as np

        def rows(a):
            return [r.tolist() for r in np.asarray(a)]
    """), "SW702")


# ---------------------------------------------------------------------------
# SW703 — unhashable literal passed to a cached builder
# ---------------------------------------------------------------------------

def test_sw703_unhashable_args_to_cached_builders_are_errors():
    fs = only(lint("""
        from functools import lru_cache, cache

        @lru_cache(maxsize=8)
        def plan(k, shape):
            return k

        class Codec:
            @cache
            def table(self, rows):
                return rows

            def go(self):
                plan(4, [1, 2])
                plan(4, shape={1: 2})
                return self.table({3})
    """), "SW703")
    assert [f.line for f in fs] == [14, 15, 16]
    assert all(f.severity == "error" for f in fs)
    assert "plan()" in fs[0].message


def test_sw703_across_modules_through_imports():
    fs = only(analyze_sources({
        "pkg/ops.py": textwrap.dedent("""
            import functools

            @functools.lru_cache(maxsize=None)
            def plan(k, shape):
                return k
        """),
        "pkg/user.py": textwrap.dedent("""
            from pkg import ops

            def go():
                return ops.plan(4, [1, 2])
        """)}), "SW703")
    assert len(fs) == 1 and fs[0].path == "pkg/user.py"


def test_sw703_hashable_args_and_uncached_functions_are_clean():
    assert not only(lint("""
        import functools

        @functools.lru_cache(maxsize=None)
        def plan(k, shape):
            return k

        def helper(rows):
            return rows

        def go():
            plan(4, (1, 2))
            return helper([1, 2])
    """), "SW703")


# ---------------------------------------------------------------------------
# SW704 — one loop-invariant tensor placed per device
# ---------------------------------------------------------------------------

def test_sw704_per_device_copies_of_one_tensor_are_flagged():
    fs = only(lint("""
        import torch

        def replicate(x, n):
            return [x.to(f"cuda:{i}", non_blocking=True)
                    for i in range(n)]

        def replicate2(x, n):
            out = []
            for i in range(n):
                out.append(x.cuda(i))
            return out
    """), "SW704")
    assert [f.line for f in fs] == [5, 11]


def test_sw704_blocks_cut_in_the_loop_are_clean():
    # ckpt/sharding.py's shard_tensor: each block is cut from the loop's
    # own cell, so data and device both track the loop
    assert not only(lint("""
        import torch

        def shard(t, cells):
            out = []
            for cell, dev in cells:
                lo, hi = cell
                view = t[lo:hi]
                out.append(view.to(dev, copy=True))
            return out
    """), "SW704")


# ---------------------------------------------------------------------------
# SW503 (torch form) — host buffer touched under an asynchronous copy
# ---------------------------------------------------------------------------

def test_sw503_write_after_async_d2h_is_flagged():
    fs = only(lint("""
        import torch

        def fetch(y):
            host = torch.empty(y.shape, pin_memory=True)
            host.copy_(y, non_blocking=True)
            host.fill_(0)
            return host
    """), "SW503")
    assert len(fs) == 1 and fs[0].severity == "error"
    assert fs[0].line == 7 and "'host' written" in fs[0].message


def test_sw503_event_or_stream_sync_makes_it_clean():
    for sync in ("ev.synchronize()", "stream.synchronize()",
                 "torch.cuda.synchronize()"):
        assert not only(lint(f"""
            import torch

            def fetch(y, stream):
                host = torch.empty(y.shape, pin_memory=True)
                host.copy_(y, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(stream)
                {sync}
                host.fill_(0)
                return host
        """), "SW503"), sync


def test_sw503_release_of_the_slab_a_view_was_cut_from():
    src = """
        import torch

        def place(pool, dev):
            buf = pool.acquire()
            host = torch.from_numpy(buf[:64]).view(torch.int32)
            t = host.to(dev, non_blocking=True)
            pool.release(buf)
            return t
    """
    fs = only(lint(src), "SW503")
    assert len(fs) == 1 and "released" in fs[0].message
    # a copy (clone) of the slab leaves nothing of it in flight
    assert not only(lint(src.replace(".view(torch.int32)",
                                     ".view(torch.int32).clone()")),
                    "SW503")


def test_sw503_refill_and_sync_through_a_helper():
    src = """
        import torch

        def wait(ev):
            ev.synchronize()

        def pump(f, buf, dev, ev):
            t = torch.from_numpy(buf).to(dev, non_blocking=True)
            ev.record()
            f.readinto(buf)
            return t
    """
    fs = only(lint(src), "SW503")
    assert len(fs) == 1 and "refilled" in fs[0].message
    assert not only(lint(src.replace("ev.record()\n",
                                     "ev.record()\n            wait(ev)\n")),
                    "SW503")


def test_sw503_copy_and_write_on_sibling_branches_are_clean():
    assert not only(lint("""
        import torch

        def f(buf, dev, fast):
            if fast:
                t = torch.from_numpy(buf).to(dev, non_blocking=True)
            else:
                buf[0] = 1
                t = None
            return t
    """), "SW503")


def test_place_block_as_written_is_clean():
    src = (REPO / STORE).read_text()
    assert SYNC_LOOP in src
    fs = analyze_sources({STORE: src})
    assert not only(fs, "SW503")


def test_place_block_without_its_sync_loop_is_flagged():
    src = (REPO / STORE).read_text().replace(SYNC_LOOP, "")
    fs = only(analyze_sources({STORE: src}), "SW503")
    assert len(fs) == 1
    f = fs[0]
    assert f.qualname.endswith("_place_block")
    assert "'buf' released" in f.message
    assert src.splitlines()[f.line - 1].strip() == "pool.release(buf)"
