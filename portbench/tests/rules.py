"""The rules every ``BENCHMARK.json`` of this benchmark keeps, as
functions of a checkout root: each returns the problems it finds, and
none where the rule holds. ``test_portbench_files.py`` holds the repo to
them; ``test_portbench_added_cell.py`` a root that adds a cell as files
and appended entries alone. No rule names a cell, a configuration or a
metric: later PRs add those."""

from __future__ import annotations

import json
import re
from pathlib import Path

from portbench import harness, trace
from portbench.tests import tiny

#: At most 64 of [A-Za-z0-9_.-], not starting with "." or "-".
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
CHIPS = (1, 4)


def names_are_unique_and_valid(root: Path) -> list:
    bench = harness.load_benchmark(root)
    out = []
    groups = {"configs": bench["configs"], "workloads": bench["workloads"],
              "metrics": bench["end_to_end"] + bench["per_layer"]}
    for group, entries in groups.items():
        seen = set()
        for e in entries:
            if not NAME.fullmatch(e["name"]):
                out.append(f"{group}: the name {e['name']!r} is not valid")
            if e["name"] in seen:
                out.append(f"{group}: {e['name']!r} twice")
            seen.add(e["name"])
    used = [w[key] for w in bench["workloads"] for key in ("config",
                                                           "traffic")]
    used += [key for c in bench["configs"] for key in c["reduced"]]
    out += [f"the name {n!r} is not valid" for n in used
            if not NAME.fullmatch(n)]
    return out


def cells_name_files_that_load(root: Path) -> list:
    """Every cell names a configuration entry whose file loads and names
    it, and a mix whose mode loads; every configuration serves a cell."""
    bench = harness.load_benchmark(root)
    out = []
    entries = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        if w["config"] not in entries:
            out.append(f"{w['name']}: no configuration {w['config']!r}")
        else:
            try:
                config = harness.load_config(bench, w["config"], root)
            except (OSError, ValueError) as e:
                out.append(f"{w['name']}: its configuration: {e}")
            else:
                if config.get("name") != w["config"]:
                    out.append(f"{w['name']}: {entries[w['config']]['file']}"
                               f" names {config.get('name')!r}")
        try:
            mode = harness.load_traffic(w["traffic"], root)["mode"]
            if not callable(harness.load_mode(mode).run):
                out.append(f"{w['name']}: mode {mode!r} has no run")
        except (OSError, ValueError, KeyError, ImportError) as e:
            out.append(f"{w['name']}: its mix {w['traffic']!r}: {e!r}")
    served = {w["config"] for w in bench["workloads"]}
    out += [f"configuration {c!r} serves no cell" for c in entries
            if c not in served]
    return out


def chips_are_one_or_four_and_four_are_few(root: Path) -> list:
    """``chips`` is 1 or 4; at most a quarter of the cells, rounded
    down, and always one, take 4."""
    cells = harness.load_benchmark(root)["workloads"]
    out = [f"{w['name']}: chips {w['chips']!r}" for w in cells
           if w["chips"] not in CHIPS]
    four = sum(w["chips"] == 4 for w in cells)
    if four > max(1, len(cells) // 4):
        out.append(f"{four} of {len(cells)} cells take 4 chips")
    return out


def metrics_have_readers_that_find_nothing_in_an_empty_run(root: Path
                                                           ) -> list:
    bench = harness.load_benchmark(root)
    empty = harness.Outcome(setup_s=1.0, attempted=0, failed=0, checks=[],
                            readings={}, window=trace.Window(False, False))
    out = []
    for m in bench["end_to_end"] + bench["per_layer"]:
        try:
            value = harness.load_metric(m["name"], root).read(empty)
        except (OSError, AttributeError) as e:
            out.append(f"{m['name']}: no reader: {e!r}")
            continue
        if value is not None and m["name"] != "setup_s":
            out.append(f"{m['name']}: read {value!r} in an empty run")
    return out


def per_layer_metrics_are_read_only_where_their_end_to_end_is(
        root: Path) -> list:
    bench = harness.load_benchmark(root)
    e2e = bench["end_to_end"]
    out = []
    for m in bench["per_layer"]:
        if m["moves"] not in {x["name"] for x in e2e}:
            out.append(f"{m['name']}: moves no end-to-end metric")
        for w in m.get("workloads", []):
            # a per-layer metric is read only where its end-to-end one is
            if not any(x["name"] == m["moves"] and w in x.get(
                    "workloads", [w]) for x in e2e):
                out.append(f"{m['name']}: read in {w}, {m['moves']} not")
    return out


def every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(
        root: Path) -> list:
    bench = harness.load_benchmark(root)
    cells = [w["name"] for w in bench["workloads"]]
    out = [f"a metric lists {w!r}, which is no cell"
           for m in bench["end_to_end"] + bench["per_layer"]
           for w in m.get("workloads", []) if w not in cells]
    for cell in cells:
        e2e = {m["name"] for m in harness.cell_metrics(bench, cell, False)}
        if "setup_s" not in e2e or len(e2e) < 2:
            out.append(f"{cell}: end-to-end metrics {sorted(e2e)}")
        if not harness.cell_metrics(bench, cell, True):
            out.append(f"{cell}: no per-layer metric")
    return out


RULES = (names_are_unique_and_valid, cells_name_files_that_load,
         chips_are_one_or_four_and_four_are_few,
         metrics_have_readers_that_find_nothing_in_an_empty_run,
         per_layer_metrics_are_read_only_where_their_end_to_end_is,
         every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric)


def problems(root: Path) -> list:
    """What every rule finds in the checkout at ``root``."""
    return [p for rule in RULES for p in rule(root)]


def linked_root(tmp: Path, bench: dict) -> Path:
    """A checkout root in ``tmp``: every file of the benchmark a link to
    the repo's, and ``bench`` as its BENCHMARK.json."""
    for path in sorted((tiny.ROOT / "portbench").rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            link = tmp / path.relative_to(tiny.ROOT)
            link.parent.mkdir(parents=True, exist_ok=True)
            link.symlink_to(path)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
