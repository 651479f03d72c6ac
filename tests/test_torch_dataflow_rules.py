"""The port's interprocedural dataflow rules (SW5xx, SW6xx) and its CLI
against the JAX package's, on the cases of ``tests/test_dataflow_rules.py``.

The SW501 positive fixture is the recycled-slab writeback race:
``np.ascontiguousarray`` on an already-contiguous row returns the input
VIEW, so submitting it to the writer pool and then recycling the pooled
slab hands the writer a buffer that may be reused mid-write; the fix
(``flatten()`` always copies) is the negative fixture. Each case runs
once per package, and every package-neutral snippet goes through both
linters, which must give the same findings. The JAX-only rules have a
counterpart per package: SW503 is read-after-donation in the JAX
package and a host buffer touched under an asynchronous copy in the
port; SW701-SW704 police ``jax.jit``/``device_put`` there and torch's
builds, syncs, cached builders and placement loops here (more cases in
``tests/test_torch_dispatch_rules.py``). Path-bound cases use each
package's own paths, and the CLI cases run each package's ``main``."""

import json

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


def lint_main(argv):
    return module(PKG, "__main__").main(argv)


def analyze_sources(*a, **kw):
    return module(PKG).analyze_sources(*a, **kw)


def lint(files_or_src, path="pkg/mod.py"):
    return twin(sources_of(files_or_src, path), PKG)


def only(findings, rule):
    return [f for f in findings if f.rule == rule]


# ---------------------------------------------------------------------------
# SW501 — pooled view escapes to an async sink before its release
# ---------------------------------------------------------------------------

_SLAB_RACE = """
    import numpy as np

    def encode(pool, wp):
        buf = pool.acquire()
        col = buf[:1024].reshape(16, 64)
        rows = [np.ascontiguousarray(col[i]) for i in range(16)]
        wp.submit("shard.dat", 0, rows)
        pool.release(buf)
"""


def test_sw501_flags_distilled_slab_race():
    fs = only(lint(_SLAB_RACE), "SW501")
    assert fs, "the distilled slab race must be flagged"
    f = fs[0]
    assert f.severity == "error"
    assert f.line == 8  # the submit
    assert "release" in f.message or "recycle" in f.message


def test_sw501_flatten_copy_is_clean():
    fixed = _SLAB_RACE.replace("np.ascontiguousarray(col[i])",
                               "col[i].flatten()")
    assert not only(lint(fixed), "SW501")


def test_sw501_token_protected_submit_is_clean():
    protected = _SLAB_RACE.replace(
        'wp.submit("shard.dat", 0, rows)',
        'wp.submit("shard.dat", 0, rows, BatchToken(16, cb))')
    assert not only(lint(protected), "SW501")


def test_sw501_interprocedural_through_helper():
    fs = only(lint("""
        def ship(wp, rows):
            wp.submit("shard.dat", 0, rows)

        def encode(pool, wp):
            buf = pool.acquire()
            ship(wp, buf[:512])
            pool.release(buf)
    """), "SW501")
    assert fs, "escape through a helper's summary must be found"
    assert "ship" in fs[0].message


def test_sw501_branch_exclusive_paths_are_clean():
    # release and escape on sibling branches can never both execute
    assert not only(lint("""
        def f(pool, q, flag):
            buf = pool.acquire()
            if flag:
                pool.release(buf)
            else:
                q.put(buf)
    """), "SW501")


# ---------------------------------------------------------------------------
# SW502 — use after release
# ---------------------------------------------------------------------------

def test_sw502_use_after_release():
    fs = only(lint("""
        def f(pool):
            buf = pool.acquire()
            view = buf[:10]
            pool.release(buf)
            return view.sum()
    """), "SW502")
    assert fs and fs[0].severity == "error"


def test_sw502_use_before_release_is_clean():
    assert not only(lint("""
        def f(pool):
            buf = pool.acquire()
            total = buf[:10].sum()
            pool.release(buf)
            return total
    """), "SW502")


# ---------------------------------------------------------------------------
# SW503 — each package's own: read after donation (JAX), a host buffer
# written or released under an asynchronous copy (port)
# ---------------------------------------------------------------------------

def own(cases: dict, **edits):
    """The snippet of the package under test, alone through its linter
    (these rules police each package's own idioms); ``edits`` maps a
    package to its (old, new) text replacement."""
    src = cases[PKG]
    if PKG in edits:
        src = src.replace(*edits[PKG])
    return module(PKG).analyze_sources(sources_of(src))


_DONATED = {"jax": """
    import jax

    def f(x):
        enc = jax.jit(lambda a: a + 1, donate_argnums=(0,))
        y = enc(x)
        return x.sum()
""", "port": """
    import torch

    def f(x, dev):
        host = torch.from_numpy(x)
        y = torch.empty(host.shape, device=dev)
        y.copy_(host, non_blocking=True)
        x[0] = 1
        return y
"""}


def test_sw503_read_after_donation():
    fs = only(own(_DONATED), "SW503")
    assert fs and fs[0].severity == "error"


def test_sw503_unread_donation_is_clean():
    assert not only(own(_DONATED, jax=("return x.sum()", "return y"),
                        port=("        x[0] = 1",
                              "        torch.cuda.synchronize()\n"
                              "        x[0] = 1")), "SW503")


def test_sw503_through_factory_summary():
    fs = only(own({"jax": """
        import jax

        def make_encoder(fn):
            return jax.jit(fn, donate_argnums=(0,))

        def run(fn, x):
            enc = make_encoder(fn)
            y = enc(x)
            return x + 1
    """, "port": """
        import torch

        def give_back(pool, buf):
            pool.release(buf)

        def place(pool, dev):
            buf = pool.acquire()
            host = torch.from_numpy(buf[:64])
            t = host.to(dev, non_blocking=True)
            give_back(pool, buf)
            return t
    """}), "SW503")
    assert fs, "the hazard through a helper's summary must be found"


def test_sw503_each_package_ignores_the_other_ones_idiom():
    other = {"jax": "port", "port": "jax"}[PKG]
    assert not only(module(PKG).analyze_sources(
        sources_of(_DONATED[other])), "SW503")


# ---------------------------------------------------------------------------
# SW601 — raw network call outside util/retry
# ---------------------------------------------------------------------------

_RAW_NET = """
    import urllib.request

    def fetch(url):
        return urllib.request.urlopen(url).read()
"""


def test_sw601_raw_urlopen_flagged():
    fs = only(lint(_RAW_NET), "SW601")
    assert fs and fs[0].severity == "error"
    assert "urlopen" in fs[0].message


def test_sw601_sanctioned_module_exempt():
    fs = lint(_RAW_NET, path="seaweedfs_tpu/util/retry.py")
    assert not only(fs, "SW601")


def test_sw601_http_client_flagged():
    fs = only(lint("""
        import http.client

        def probe(host):
            return http.client.HTTPConnection(host)
    """), "SW601")
    assert fs


# ---------------------------------------------------------------------------
# SW602 — handler with no reachable deadline_scope
# ---------------------------------------------------------------------------

_HANDLER = """
    import urllib.request

    def fetch(url):
        return urllib.request.urlopen(url, timeout=2).read()

    class H:
        def do_GET(self):
            return fetch("http://127.0.0.1/x")
"""


def test_sw602_handler_without_deadline():
    fs = only(lint(_HANDLER), "SW602")
    assert fs and fs[0].severity == "warning"
    assert "do_GET" in fs[0].qualname


def test_sw602_deadline_scope_on_path_is_clean():
    guarded = _HANDLER.replace(
        'return fetch("http://127.0.0.1/x")',
        'with deadline_scope(1.0):\n'
        '            return fetch("http://127.0.0.1/x")')
    assert not only(lint(guarded), "SW602")


def test_sw602_non_handler_not_flagged():
    # the raw call itself is SW601; SW602 is handler-entry coverage
    renamed = _HANDLER.replace("do_GET", "lookup")
    assert not only(lint(renamed), "SW602")


# ---------------------------------------------------------------------------
# SW603 — unbounded retry loop
# ---------------------------------------------------------------------------

_RETRY_LOOP = """
    import time
    import urllib.request

    def pull(url):
        while True:
            try:
                return urllib.request.urlopen(url)
            except OSError:
                time.sleep(1.0)
"""


def test_sw603_retry_loop_without_budget():
    fs = only(lint(_RETRY_LOOP), "SW603")
    assert fs and fs[0].severity == "warning"


def test_sw603_breaker_guard_is_clean():
    guarded = _RETRY_LOOP.replace("while True:",
                                  "while not breaker.is_open():")
    assert not only(lint(guarded), "SW603")


# ---------------------------------------------------------------------------
# SW701-SW704 — dispatch hazards: jax.jit/device_put (JAX), builds,
# syncs, cached builders and placement loops (port)
# ---------------------------------------------------------------------------

def test_sw701_jit_in_loop():
    fs = only(own({"jax": """
        import jax

        def f(xs):
            out = []
            for x in xs:
                out.append(jax.jit(lambda a: a * 2)(x))
            return out
    """, "port": """
        import torch

        def f(xs):
            out = []
            for x in xs:
                out.append(torch.compile(lambda a: a * 2)(x))
            return out
    """}), "SW701")
    assert fs and fs[0].severity == "warning"


def test_sw701_jit_outside_loop_is_clean():
    assert not only(own({"jax": """
        import jax

        def f(xs):
            g = jax.jit(lambda a: a * 2)
            return [g(x) for x in xs]
    """, "port": """
        import torch

        def f(xs):
            g = torch.compile(lambda a: a * 2)
            return [g(x) for x in xs]
    """}), "SW701")


def test_sw702_device_put_in_loop():
    fs = only(own({"jax": """
        import jax

        def g(batches):
            for b in batches:
                jax.device_put(b)
    """, "port": """
        import torch

        def g(batches, dev):
            for b in batches:
                b.to(dev)
    """}), "SW702")
    assert fs and fs[0].severity == "warning"


def test_sw704_loop_invariant_data_per_device():
    fs = only(own({"jax": """
        import jax

        def broadcast(x, devices):
            for d in devices:
                jax.device_put(x, d)
    """, "port": """
        import torch

        def broadcast(x, devices):
            for d in devices:
                x.to(d, non_blocking=True)
    """}), "SW704")
    assert fs and fs[0].severity == "warning"
    assert {"jax": "NamedSharding", "port": "broadcast"}[PKG] in \
        fs[0].message


def test_sw704_sharding_kwarg_in_comprehension():
    fs = only(own({"jax": """
        import jax

        def broadcast(x, shardings):
            return [jax.device_put(x, device=s) for s in shardings]
    """, "port": """
        import torch

        def broadcast(x, devices):
            return [x.to(device=d) for d in devices]
    """}), "SW704")
    assert fs and fs[0].severity == "warning"


def test_sw704_per_shard_transfer_is_clean():
    # distinct blocks onto distinct devices is a legitimate per-shard
    # transfer — neither SW702 nor SW704 applies
    fs = own({"jax": """
        import jax

        def restore(blocks, devices):
            out = []
            for blk, d in zip(blocks, devices):
                out.append(jax.device_put(blk, d))
            return out
    """, "port": """
        import torch

        def restore(blocks, devices):
            out = []
            for blk, d in zip(blocks, devices):
                out.append(blk.to(d))
            return out
    """})
    assert not only(fs, "SW704") and not only(fs, "SW702")


def test_sw702_still_fires_without_device_arg():
    fs = own({"jax": """
        import jax

        def g(batches):
            for b in batches:
                jax.device_put(b)
    """, "port": """
        import torch

        def g(batches):
            for b in batches:
                b.cuda()
    """})
    assert only(fs, "SW702") and not only(fs, "SW704")


_STATIC = {"jax": """
    import jax

    def h(fn, x):
        f = jax.jit(fn, static_argnums=(1,))
        return f(x, [1, 2])
""", "port": """
    import functools

    @functools.lru_cache(maxsize=None)
    def build(fn, key):
        return fn(key)

    def h(fn, x):
        return build(fn, [1, 2])
"""}


def test_sw703_unhashable_static_arg():
    fs = only(own(_STATIC), "SW703")
    assert fs and fs[0].severity == "error"


def test_sw703_hashable_static_arg_is_clean():
    assert not only(own(_STATIC, jax=("[1, 2]", "(1, 2)"),
                        port=("[1, 2]", "(1, 2)")), "SW703")


# ---------------------------------------------------------------------------
# pragmas apply to the new families too
# ---------------------------------------------------------------------------

def test_sw601_pragma_suppresses():
    pragmad = _RAW_NET.replace(
        "return urllib.request.urlopen(url).read()",
        "return urllib.request.urlopen(url).read()  "
        "# seaweedlint: disable=SW601 — test fixture")
    assert not only(lint(pragmad), "SW601")


# ---------------------------------------------------------------------------
# CLI satellites: SARIF, prune, --fail-stale, --stats, budget
# ---------------------------------------------------------------------------

_RAW_NET_FILE = ("import urllib.request\n\n\n"
                 "def fetch(url):\n"
                 "    return urllib.request.urlopen(url).read()\n")


def test_sarif_output_round_trips(tmp_path, capsys):
    mod = tmp_path / "netmod.py"
    mod.write_text(_RAW_NET_FILE)
    rc = lint_main([str(mod), "--no-baseline", "--format", "sarif",
                    "--gate", "none"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "seaweedlint"
    results = run["results"]
    sw601 = [r for r in results if r["ruleId"] == "SW601"]
    assert sw601, results
    r = sw601[0]
    assert r["level"] == "error"
    loc = r["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("netmod.py")
    assert loc["region"]["startLine"] == 5
    assert r["partialFingerprints"]["seaweedlint/v1"]
    rule_ids = {ru["id"] for ru in run["tool"]["driver"]["rules"]}
    assert "SW601" in rule_ids


def test_prune_baseline_and_fail_stale(tmp_path, capsys):
    mod = tmp_path / "netmod.py"
    mod.write_text(_RAW_NET_FILE)
    bl = tmp_path / "baseline.json"
    # 1. baseline the SW601 finding -> gate clean
    assert lint_main([str(mod), "--baseline", str(bl),
                      "--write-baseline"]) == 0
    assert lint_main([str(mod), "--baseline", str(bl)]) == 0
    # 2. fix the finding -> the entry is now stale; --fail-stale trips
    mod.write_text("def fetch(url):\n    return url\n")
    assert lint_main([str(mod), "--baseline", str(bl)]) == 0
    assert lint_main([str(mod), "--baseline", str(bl),
                      "--fail-stale"]) == 1
    # 3. prune drops it; --fail-stale is quiet again
    capsys.readouterr()
    assert lint_main([str(mod), "--baseline", str(bl),
                      "--prune-baseline"]) == 0
    out = capsys.readouterr().out
    assert "pruned 1 stale entry" in out
    assert json.loads(bl.read_text())["findings"] == []
    assert lint_main([str(mod), "--baseline", str(bl),
                      "--fail-stale"]) == 0


def test_stats_reports_dataflow_phase(tmp_path, capsys):
    mod = tmp_path / "m.py"
    mod.write_text("x = 1\n")
    assert lint_main([str(mod), "--no-baseline", "--stats"]) == 0
    out = capsys.readouterr().out
    assert "per-rule-family wall time" in out
    assert "dataflow fixpoint" in out


def test_budget_exceeded_fails(tmp_path, capsys):
    mod = tmp_path / "m.py"
    mod.write_text("x = 1\n")
    rc = lint_main([str(mod), "--no-baseline",
                    "--budget-seconds", "0.000001"])
    assert rc == 1
    assert "runtime budget exceeded" in capsys.readouterr().err


def test_timings_cover_every_phase():
    timings = {}
    analyze_sources({"pkg/m.py": "x = 1\n"}, timings=timings)
    for phase in ("parse+model", "callgraph", "dataflow fixpoint",
                  "SW5xx buffer", "SW6xx net",
                  {"jax": "SW7xx jax", "port": "SW7xx torch"}[PKG]):
        assert phase in timings


def test_json_output_exit_codes_and_cache_name(tmp_path, capsys):
    mod = tmp_path / "netmod.py"
    mod.write_text(_RAW_NET_FILE)
    # the SW601 error gates at the default (warning) gate: exit 1
    assert lint_main([str(mod), "--no-baseline", "--format", "json",
                      "--no-cache"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["gating"] == 1
    assert [f["rule"] for f in doc["findings"]] == ["SW601"]
    assert doc["findings"][0]["line"] == 5
    # no gate: exit 0; a bad invocation: exit 2
    assert lint_main([str(mod), "--no-baseline", "--gate", "none",
                      "--no-cache"]) == 0
    with pytest.raises(SystemExit) as e:
        lint_main([str(mod), "--gate", "bogus"])
    assert e.value.code == 2
    # each linter keeps its own result cache, so the two never thrash
    assert module(PKG, "cache").DEFAULT_CACHE == {
        "jax": ".seaweedlint_cache.json",
        "port": ".seaweedlint_torch_cache.json"}[PKG]
