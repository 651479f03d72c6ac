"""The port's SW8xx race rules against the JAX package's, on the cases of
``tests/test_race_rules.py``: positive and negative fixtures per rule,
the pinned real race (the distilled UsagePusher race: a daemon pusher
thread and the caller thread bump one counter with no shared lock) and
the SARIF rules metadata. Each case runs once per package, and every
snippet goes through both linters, which must give the same findings."""

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


def to_sarif(*a, **kw):
    return module(PKG, "findings").to_sarif(*a, **kw)


def lint(files_or_src, path="pkg/mod.py"):
    return twin(sources_of(files_or_src, path), PKG)


def only(findings, rule):
    return [f for f in findings if f.rule == rule]


# ---------------------------------------------------------------------------
# SW801 — attribute written from >=2 roles with no common lock
# ---------------------------------------------------------------------------

def test_sw801_two_roles_no_common_lock():
    fs = lint("""
        import threading

        class Stats:
            def __init__(self):
                self.count = 0
                threading.Thread(target=self._loop,
                                 name="pusher").start()

            def _loop(self):
                self.count = 1

            def record(self):
                self.count = 2
    """)
    (f,) = only(fs, "SW801")
    assert f.severity == "error"
    assert "'count'" in f.message
    assert "pusher" in f.message and "main" in f.message


def test_sw801_clean_when_all_writes_share_a_lock():
    fs = lint("""
        import threading

        class Stats:
            def __init__(self):
                self.count = 0
                self._mu = threading.Lock()
                threading.Thread(target=self._loop,
                                 name="pusher").start()

            def _loop(self):
                with self._mu:
                    self.count = 1

            def record(self):
                with self._mu:
                    self.count = 2
    """)
    assert not only(fs, "SW801")


def test_sw801_single_role_is_not_shared():
    fs = lint("""
        import threading

        class Loop:
            def __init__(self):
                self.ticks = 0
                threading.Thread(target=self._run,
                                 name="ticker").start()

            def _run(self):
                self.ticks = 1
                self._more()

            def _more(self):
                self.ticks = 2
    """)
    assert not only(fs, "SW801")


def test_sw801_multi_instance_role_races_itself():
    fs = lint("""
        import threading

        class Pool:
            def __init__(self):
                self.done = 0
                for i in range(4):
                    threading.Thread(target=self._work,
                                     name="worker").start()

            def _work(self):
                self.done = 1
    """)
    (f,) = only(fs, "SW801")
    assert "worker" in f.message


# The pinned real-race regression. The helper is reached from the
# pusher thread's steady loop AND from a caller-thread method (named
# `flush`, deliberately NOT `stop`/`close` — lifecycle writes are
# exempt by design and must not hide this).
_PINNED_USAGE_RACE = """
    import threading

    class UsagePusher:
        def __init__(self):
            self.pushed = 0
            self.errors = 0
            self._t = threading.Thread(target=self._loop,
                                       name="usage-pusher",
                                       daemon=True)
            self._t.start()

        def _loop(self):
            while True:
                self.push_once()

        def push_once(self):
            self.pushed += 1

        def flush(self):
            self.push_once()
"""


def test_sw801_pinned_real_race_must_flag():
    fs = lint(_PINNED_USAGE_RACE)
    hits = only(fs, "SW801")
    assert hits, ("the distilled UsagePusher race MUST stay flagged: "
                  "if this fails, the SW801 role/lockset analysis "
                  "regressed")
    (f,) = [h for h in hits if "'pushed'" in h.message]
    assert f.severity == "error"
    assert "usage-pusher" in f.message and "main" in f.message


def test_sw801_pinned_race_pragma_suppresses():
    src = _PINNED_USAGE_RACE.replace(
        "self.pushed += 1",
        "self.pushed += 1  # seaweedlint: disable=SW801,SW802 — test")
    fs = lint(src)
    assert not only(fs, "SW801")


# ---------------------------------------------------------------------------
# SW802 — compound update (RMW / check-then-set) outside any lock
# ---------------------------------------------------------------------------

def test_sw802_rmw_outside_lock():
    fs = lint("""
        import threading

        class Gauge:
            def __init__(self):
                self.best = 0
                threading.Thread(target=self._watch,
                                 name="watcher").start()

            def _watch(self):
                self.best += 1
    """)
    (f,) = only(fs, "SW802")
    assert f.severity == "warning"
    assert "read-modify-write" in f.message


def test_sw802_check_then_set_outside_lock():
    fs = lint("""
        import threading

        class Gauge:
            def __init__(self):
                self.peak = 0
                threading.Thread(target=self._watch,
                                 name="watcher").start()

            def _watch(self, v):
                if v > self.peak:
                    self.peak = v
    """)
    hits = only(fs, "SW802")
    assert any("check-then-set" in f.message for f in hits)


def test_sw802_clean_under_lock():
    fs = lint("""
        import threading

        class Gauge:
            def __init__(self):
                self.best = 0
                self._mu = threading.Lock()
                threading.Thread(target=self._watch,
                                 name="watcher").start()

            def _watch(self):
                with self._mu:
                    self.best += 1
    """)
    assert not only(fs, "SW802")


def test_sw802_not_raised_for_main_only_objects():
    fs = lint("""
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                self.n += 1
    """)
    assert not only(fs, "SW802")


def test_sw801_claims_the_attr_over_sw802():
    # two roles write via RMW with no lock: SW801 (error) owns the
    # attribute; SW802 must not double-report the same sites
    fs = lint(_PINNED_USAGE_RACE)
    assert only(fs, "SW801")
    assert not [f for f in only(fs, "SW802")
                if "'pushed'" in f.message]


# ---------------------------------------------------------------------------
# SW803 — unguarded dict/list/set mutation on a shared collection
# ---------------------------------------------------------------------------

def test_sw803_unguarded_dict_mutation():
    fs = lint("""
        import threading

        class Registry:
            def __init__(self):
                self.entries = {}
                threading.Thread(target=self._reap,
                                 name="reaper").start()

            def _reap(self):
                self.entries.clear()

            def put(self, k, v):
                self.entries[k] = v
    """)
    hits = only(fs, "SW803")
    assert hits and all(f.severity == "warning" for f in hits)
    assert any("dict" in f.message for f in hits)


def test_sw803_clean_under_lock():
    fs = lint("""
        import threading

        class Registry:
            def __init__(self):
                self.entries = {}
                self._mu = threading.Lock()
                threading.Thread(target=self._reap,
                                 name="reaper").start()

            def _reap(self):
                with self._mu:
                    self.entries.clear()

            def put(self, k, v):
                with self._mu:
                    self.entries[k] = v
    """)
    assert not only(fs, "SW803")


def test_sw803_needs_container_typed_in_init():
    # attr never typed as a container in __init__: the rule stays quiet
    # rather than guessing
    fs = lint("""
        import threading

        class Registry:
            def __init__(self):
                self.entries = make_entries()
                threading.Thread(target=self._reap,
                                 name="reaper").start()

            def _reap(self):
                self.entries.clear()
    """)
    assert not only(fs, "SW803")


# ---------------------------------------------------------------------------
# SW804 — publish before construction completes
# ---------------------------------------------------------------------------

def test_sw804_write_after_thread_start_in_init():
    fs = lint("""
        import threading

        class Pusher:
            def __init__(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()
                self.interval = 5.0

            def _run(self):
                pass
    """)
    (f,) = only(fs, "SW804")
    assert f.severity == "error"
    assert "published before construction completes" in f.message


def test_sw804_clean_when_publish_is_last():
    fs = lint("""
        import threading

        class Pusher:
            def __init__(self):
                self.interval = 5.0
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                pass
    """)
    assert not only(fs, "SW804")


# ---------------------------------------------------------------------------
# SARIF rules metadata (satellite: --format=sarif SW8xx catalog)
# ---------------------------------------------------------------------------

def test_sarif_emits_sw8xx_rule_metadata_even_with_no_findings():
    doc = to_sarif([])
    rules = {r["id"]: r
             for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    for rule in ("SW801", "SW802", "SW803", "SW804"):
        assert rule in rules, rule
        r = rules[rule]
        assert r["name"] == module(PKG, "findings").RULE_META[rule]["name"]
        assert r["help"]["text"]
        # the JAX package points at its docs page, the port at its README
        assert r["helpUri"] == {"jax": "docs/static_analysis.md",
                                "port": "README.md"}[PKG]
    assert rules["SW801"]["defaultConfiguration"]["level"] == "error"
    assert rules["SW804"]["defaultConfiguration"]["level"] == "error"
    assert rules["SW802"]["defaultConfiguration"]["level"] == "warning"
    assert rules["SW803"]["defaultConfiguration"]["level"] == "warning"
