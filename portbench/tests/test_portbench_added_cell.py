"""A cell is added as files and appended ``BENCHMARK.json`` entries alone:
in a root whose every benchmark file is a link to the repo's, a new
configuration file, a new mix file, and the cell's entries appended
(its configuration and workload, and its name in the ``workloads`` of
each metric it reports). The rules hold there, and the cell runs through
``python3 -m portbench`` at the CPU size its files give."""

import json

from portbench import harness
from portbench.tests import rules, tiny

CELL = CONFIG = MIX = "seal_large_rows"
#: The cell whose metrics the new one reports (seal_gibps, setup_s and
#: every .seal per-layer metric) and whose configuration it starts from.
LIKE = "seal_1gib_volumes"
#: Two 655,360 B large rows, each split at the 4 MiB batch bound into a
#: 419,328 B column chunk and a 236,032 B straggler; then one whole
#: 131,072 B small row and one padded one.
TINY_CONFIG = {"scheme": {"large_block_bytes": 655_360,
                          "small_block_bytes": 131_072},
               "volume_bytes": 15_000_000}


def _added(tmp):
    """The root, the BENCHMARK.json it started from, and the one it ends
    with."""
    before = harness.load_benchmark(tiny.ROOT)
    bench = json.loads(json.dumps(before))
    like = harness.workload(bench, LIKE)
    config = dict(harness.load_config(bench, like["config"]), name=CONFIG,
                  tiny=TINY_CONFIG)
    bench["configs"].append({
        "name": CONFIG, "source": config["source"],
        "file": f"portbench/configs/{CONFIG}.json",
        "reduced": config["reduced"], "why": "a test: large rows"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
        "why": "a test: volumes with large rows through one call"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if LIKE in m.get("workloads", ()):
            m["workloads"].append(CELL)
    root = rules.linked_root(tmp, bench)
    (root / bench["configs"][-1]["file"]).write_text(json.dumps(config))
    mix = dict(harness.load_traffic(like["traffic"]),
               tiny={"pool_volumes": 2, "warmup_volumes": 1,
                     "check_share": 1.0})
    (root / "portbench" / "traffic" / f"{MIX}.json").write_text(
        json.dumps(mix))
    return root, before, bench


def _appended_only(before, after) -> bool:
    """Whether ``after`` is ``before`` with entries, and names in the
    metrics' ``workloads``, appended and nothing else changed."""
    if set(before) != set(after):
        return False
    for key, old in before.items():
        new = after[key]
        if not isinstance(old, list) or not old or \
                not isinstance(old[0], dict):
            if new != old:
                return False
            continue
        for o, n in zip(old, new):
            w_old, w_new = o.get("workloads"), n.get("workloads")
            if {k: v for k, v in o.items() if k != "workloads"} != \
                    {k: v for k, v in n.items() if k != "workloads"} or \
                    (w_old is not None and w_new[:len(w_old)] != w_old):
                return False
        if len(new) < len(old):
            return False
    return True


def _lines(proc) -> tuple[dict, dict]:
    """The run's info (its ``portbench:`` line) and its result."""
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-2][len("portbench: "):]), json.loads(lines[-1])


def test_a_cell_added_as_files_and_appended_entries_alone_is_checked_and_runs(
        tmp_path):
    root, before, bench = _added(tmp_path)
    for path in (tiny.ROOT / "portbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (root / path.relative_to(tiny.ROOT)).resolve() == path
    assert _appended_only(before, bench)
    assert rules.problems(root) == []

    info, res = _lines(tiny.run_cli(CELL, root=root))
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in harness.cell_metrics(
        bench, CELL, False)} >= {"seal_gibps", "setup_s"}
    # every row checked, large rows among them: two large and two small
    # a volume; each large row is a column chunk and a straggler, each a
    # batch of its own at the 4 MiB bound
    assert info["rows_checked"] == 4 * info["volumes"] > 0
    assert info["batches"] >= 4 * info["volumes"]

    info, res = _lines(tiny.run_cli(CELL, trace=1, root=root))
    assert res["correct"] is True, res["checks"]
    names = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert "pack_busy.seal" in res["metrics"] and set(res["metrics"]) <= names
    assert info["rows_checked"] == 4 * info["volumes"] > 0
    assert CELL in tiny.cells("seal", root)
