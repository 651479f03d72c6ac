"""The port's linter (``seaweedfs_tpu_torch.analysis``) against the JAX
package's, on the cases of ``tests/test_seaweedlint.py``: one positive
and one negative fixture per rule, suppression pragmas, fingerprint
stability and the baseline diff. Each case runs once per package, and
every snippet goes through both linters, which must give the same
findings (``torch_lint.twin``). The port's own tree must lint clean at
severity error with nothing in its baseline but warnings."""

import json
import textwrap

import pytest

from torch_lint import PKGS, module, sources_of, twin
from torch_teardown import collect_jax_garbage  # noqa: F401


@pytest.fixture(autouse=True, params=PKGS)
def pkg(request):
    """Every case runs once per package; ``lint`` runs both and holds
    them equal, then answers for this one."""
    global PKG
    PKG = request.param
    yield PKG


PKG = "port"


def write_baseline(*a, **kw):
    return module(PKG).write_baseline(*a, **kw)


def load_baseline(*a, **kw):
    return module(PKG).load_baseline(*a, **kw)


def diff_baseline(*a, **kw):
    return module(PKG).diff_baseline(*a, **kw)


def lint(files_or_src, path="pkg/mod.py"):
    return twin(sources_of(files_or_src, path), PKG)


def rules(findings):
    return {f.rule for f in findings}


def only(findings, rule):
    return [f for f in findings if f.rule == rule]


# ---------------------------------------------------------------------------
# SW001 — syntax errors
# ---------------------------------------------------------------------------

def test_syntax_error_is_reported_not_raised():
    fs = lint("def broken(:\n    pass\n")
    assert [f.rule for f in fs] == ["SW001"]
    assert fs[0].severity == "error"


# ---------------------------------------------------------------------------
# SW101 / SW102 — lock-order graph
# ---------------------------------------------------------------------------

_INVERTED = """
    import threading

    class S:
        def __init__(self):
            self.lock_a = threading.Lock()
            self.lock_b = threading.Lock()

        def one(self):
            with self.lock_a:
                with self.lock_b:
                    pass

        def two(self):
            with self.lock_b:
                with self.lock_a:
                    pass
"""


def test_lock_order_cycle_detected():
    fs = only(lint(_INVERTED), "SW101")
    assert fs, "expected a lock-order cycle"
    assert all(f.severity == "error" for f in fs)
    msg = " ".join(f.message for f in fs)
    assert "lock_a" in msg and "lock_b" in msg


def test_consistent_order_no_cycle():
    consistent = _INVERTED.replace(
        "with self.lock_b:\n                with self.lock_a:",
        "with self.lock_a:\n                with self.lock_b:")
    fs = lint(consistent)
    assert not only(fs, "SW101")
    # nested acquisition is still surfaced as info
    nested = only(fs, "SW102")
    assert nested and all(f.severity == "info" for f in nested)


def test_nonreentrant_self_reacquire_is_error():
    fs = lint("""
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
    """)
    assert only(fs, "SW101"), "re-acquiring a non-reentrant Lock " \
        "through a call chain must be flagged"


# ---------------------------------------------------------------------------
# SW103 — blocking I/O while holding a lock
# ---------------------------------------------------------------------------

def test_sleep_under_lock_is_error():
    fs = only(lint("""
        import threading
        import time

        class P:
            def __init__(self):
                self._lock = threading.Lock()

            def tick(self):
                with self._lock:
                    time.sleep(1)
    """), "SW103")
    assert len(fs) == 1 and fs[0].severity == "error"
    assert "sleep" in fs[0].message


def test_sleep_outside_lock_ok():
    fs = lint("""
        import threading
        import time

        class P:
            def __init__(self):
                self._lock = threading.Lock()

            def tick(self):
                with self._lock:
                    n = 1
                time.sleep(n)
    """)
    assert not only(fs, "SW103")


def test_blocking_call_found_across_modules():
    fs = only(lint({
        "pkg/a.py": textwrap.dedent("""
            import threading
            from pkg.b import slow_write

            class A:
                def __init__(self):
                    self._lock = threading.Lock()

                def save(self):
                    with self._lock:
                        slow_write()
        """),
        "pkg/b.py": textwrap.dedent("""
            import time

            def slow_write():
                time.sleep(0.5)
        """),
    }), "SW103")
    assert fs, "fixpoint must propagate blocking through the call"
    assert "slow_write" in fs[0].message


# ---------------------------------------------------------------------------
# SW201 / SW202 — resource hygiene
# ---------------------------------------------------------------------------

def test_unclosed_file_is_error():
    fs = only(lint("""
        def dump(p, data):
            f = open(p, "w")
            f.write(data)
    """), "SW201")
    assert len(fs) == 1 and fs[0].severity == "error"


def test_close_outside_finally_is_warning():
    fs = only(lint("""
        def dump(p, data):
            f = open(p, "w")
            f.write(data)
            f.close()
    """), "SW201")
    assert len(fs) == 1 and fs[0].severity == "warning"


def test_with_block_and_finally_are_clean():
    fs = lint("""
        def dump(p, data):
            with open(p, "w") as f:
                f.write(data)

        def dump2(p, data):
            f = open(p, "w")
            try:
                f.write(data)
            finally:
                f.close()
    """)
    assert not only(fs, "SW201")


def test_inline_open_read_is_error():
    fs = only(lint("def peek(p):\n    return open(p).read()\n"),
              "SW201")
    assert len(fs) == 1 and fs[0].severity == "error"


def test_escaped_resource_not_flagged():
    fs = lint("""
        def attach(self, p):
            f = open(p, "w")
            self._sink = f
    """)
    assert not only(fs, "SW201")


def test_span_outside_with_flagged():
    fs = lint("""
        import seaweedfs_tpu.util.tracing as tracing

        def work():
            s = tracing.span("op")
            return 1

        def good():
            with tracing.span("op"):
                return 1
    """)
    spans = only(fs, "SW202")
    assert len(spans) == 1
    assert spans[0].qualname.endswith("work")


# ---------------------------------------------------------------------------
# SW301 / SW302 — swallowed exceptions
# ---------------------------------------------------------------------------

def test_silent_handler_in_heartbeat_is_error():
    fs = only(lint("""
        def heartbeat(self):
            try:
                self.ping()
            except Exception:
                pass
    """), "SW301")
    assert len(fs) == 1 and fs[0].severity == "error"


def test_silent_handler_elsewhere_is_warning():
    fs = only(lint("""
        def parse(raw):
            try:
                return int(raw)
            except ValueError:
                pass
    """), "SW301")
    assert len(fs) == 1 and fs[0].severity == "warning"


def test_logged_handler_is_clean():
    fs = lint("""
        from seaweedfs_tpu.util import glog

        def heartbeat(self):
            try:
                self.ping()
            except Exception as e:
                glog.v(1, "ping failed: %s", e)
    """)
    assert not only(fs, "SW301") and not only(fs, "SW302")


def test_bare_except_is_error_unless_reraised():
    fs = lint("""
        def a():
            try:
                work()
            except:
                pass

        def b():
            try:
                work()
            except:
                raise
    """)
    bares = only(fs, "SW302")
    assert len(bares) == 1
    assert bares[0].qualname.endswith("a")


# ---------------------------------------------------------------------------
# SW401 / SW402 — metrics label hygiene
# ---------------------------------------------------------------------------

def test_fstring_label_is_error():
    fs = only(lint("""
        def record(metrics, code):
            metrics.counter("requests", status=f"code-{code}")
    """), "SW401")
    assert len(fs) == 1 and fs[0].severity == "error"


def test_constant_label_is_clean():
    fs = lint("""
        def record(metrics):
            metrics.counter("requests", status="ok")
    """)
    assert not only(fs, "SW401") and not only(fs, "SW402")


def test_variable_label_and_dynamic_name_are_info():
    fs = lint("""
        def record(metrics, name, status):
            metrics.counter(name, status=status)
    """)
    assert only(fs, "SW402")
    assert all(f.severity == "info" for f in only(fs, "SW402"))


# ---------------------------------------------------------------------------
# Suppression pragmas
# ---------------------------------------------------------------------------

def test_pragma_on_line_suppresses():
    fs = lint("""
        def parse(raw):
            try:
                return int(raw)
            except ValueError:  # seaweedlint: disable=SW301 — probing
                pass
    """)
    assert not only(fs, "SW301")


def test_pragma_line_above_suppresses():
    fs = lint("""
        import threading
        import time

        class P:
            def __init__(self):
                self._lock = threading.Lock()

            def tick(self):
                # seaweedlint: disable=SW103 — test fixture
                with self._lock:
                    time.sleep(1)
    """)
    assert not only(fs, "SW103")


def test_pragma_for_other_rule_does_not_suppress():
    fs = lint("""
        def parse(raw):
            try:
                return int(raw)
            except ValueError:  # seaweedlint: disable=SW999 — wrong id
                pass
    """)
    assert only(fs, "SW301")


# ---------------------------------------------------------------------------
# SW901 — rename commit points must be durable
# ---------------------------------------------------------------------------

# fixture: a two-phase vacuum swap renaming .cpd/.cpx into place with
# no fsync on either side — the shape durable_replace exists for
_BARE_SWAP = """
    import os

    def commit_compact(base):
        os.replace(base + ".cpd", base + ".dat")
        os.replace(base + ".cpx", base + ".idx")
"""

# fixture: a tier download moving its .part into place
_PART_INSTALL = """
    import os

    def finish_download(part, final):
        os.rename(part, final)
"""


def test_sw901_bare_rename_commit_flagged():
    fs = only(lint(_BARE_SWAP), "SW901")
    assert len(fs) == 2
    assert all(f.severity == "warning" for f in fs)
    assert "durable_replace" in fs[0].message


def test_sw901_bare_os_rename_flagged():
    fs = only(lint(_PART_INSTALL), "SW901")
    assert len(fs) == 1


def test_sw901_durable_replace_idiom_clean():
    fs = lint("""
        import os
        from seaweedfs_tpu.util.durability import durable_replace

        def commit(base):
            durable_replace(base + ".cpd", base + ".dat")
    """)
    assert not only(fs, "SW901")


def test_sw901_manual_fsync_pair_clean():
    fs = lint("""
        import os
        from seaweedfs_tpu.util.durability import fsync_dir

        def install(tmp, final):
            fd = os.open(tmp, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
            os.replace(tmp, final)
            fsync_dir("/data")
    """)
    assert not only(fs, "SW901")


def test_sw901_fsync_on_wrong_side_still_flagged():
    # source fsynced, but the rename's directory entry never persisted
    fs = only(lint("""
        import os

        def install(tmp, final):
            fd = os.open(tmp, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
            os.replace(tmp, final)
            return final
    """), "SW901")
    assert len(fs) == 1
    assert "parent directory" in fs[0].message


def test_sw901_pragma_with_reason_suppresses():
    fs = lint("""
        import os

        def park_corrupt(path, qdir):
            # seaweedlint: disable=SW901 — forensic move, not a commit point
            os.replace(path, qdir + "/bad")
    """)
    assert not only(fs, "SW901")


# ---------------------------------------------------------------------------
# Fingerprints + baseline diff
# ---------------------------------------------------------------------------

_LEAK = """
def dump(p, data):
    f = open(p, "w")
    f.write(data)
"""


def test_fingerprint_stable_under_line_drift():
    before = lint(_LEAK)
    after = lint("# comment\n# more preamble\n\n" + _LEAK)
    assert {f.fingerprint for f in before} == \
        {f.fingerprint for f in after}
    assert before[0].line != after[0].line


def test_baseline_roundtrip_and_diff(tmp_path):
    findings = lint(_LEAK)
    path = tmp_path / "baseline.json"
    write_baseline(path, findings)
    base = load_baseline(path)
    assert len(base["findings"]) == len(findings)

    # same code -> nothing new, nothing stale
    new, stale = diff_baseline(lint(_LEAK), base)
    assert not new and not stale

    # a second leak -> exactly the new one reported
    two = lint(_LEAK + "\ndef dump2(p, data):\n"
               "    g = open(p, 'w')\n    g.write(data)\n")
    new, stale = diff_baseline(two, base)
    assert len(new) == 1 and "dump2" in new[0].qualname
    assert not stale

    # leak fixed -> baseline entry is stale
    new, stale = diff_baseline([], base)
    assert not new and len(stale) == len(findings)


def test_write_baseline_preserves_justifications(tmp_path):
    findings = lint(_LEAK)
    path = tmp_path / "baseline.json"
    base = write_baseline(path, findings)
    base["findings"][0]["justification"] = "kept open on purpose"
    path.write_text(json.dumps(base))

    rewritten = write_baseline(path, lint(_LEAK),
                               previous=load_baseline(path))
    assert rewritten["findings"][0]["justification"] == \
        "kept open on purpose"


@pytest.mark.parametrize("pkg", ["port"])
def test_port_tree_has_no_unbaselined_errors(pkg):
    """The port's tree must be clean at severity=error and hold no error
    in its baseline (warnings are baselined, each with a justification;
    see seaweedfs_tpu_torch/analysis/baseline.json). The JAX tree is
    ``tests/test_seaweedlint.py``'s."""
    from pathlib import Path
    from seaweedfs_tpu_torch.analysis import analyze_paths
    from seaweedfs_tpu_torch.analysis.__main__ import _DEFAULT_BASELINE
    root = Path(__file__).resolve().parent.parent
    findings = analyze_paths(["seaweedfs_tpu_torch"], root)
    errors = [f for f in findings if f.severity == "error"]
    assert not errors, "\n".join(
        f"{f.path}:{f.line} {f.rule} {f.message}" for f in errors)
    base = json.loads(_DEFAULT_BASELINE.read_text())["findings"]
    assert base and all(e["severity"] == "warning"
                        and e.get("justification") for e in base)
    assert _DEFAULT_BASELINE.parent == \
        root / "seaweedfs_tpu_torch" / "analysis"
