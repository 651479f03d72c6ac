"""Each cell end to end on the CPU at the tiny size, through the command's
own code, with the kernels' plain versions; and what a run refuses."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench.modes import seal
from portbench.tests import tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _last_line(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _modules(proc) -> set:
    line = proc.stderr.strip().splitlines()[-1]
    assert line.startswith("MODULES ")
    return set(json.loads(line[len("MODULES "):]))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_runs_end_to_end_and_prints_the_result_line(cell, tmp_path):
    root = tiny.root_for(cell, tmp_path)
    proc = tiny.run_cli(cell, root=root)
    res = _last_line(proc)
    assert list(res)[:5] == RESULT_KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    want = {m["name"] for m in harness.cell_metrics(
        harness.load_benchmark(root), cell, False)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["device"]["count"] == 1
    # each number compared, beside its limit, last on standard error
    errs = proc.stderr.strip().splitlines()[:-1]
    assert errs[-len(res["checks"]):] == [
        harness.Check(n, c["value"], c.get("max"), c.get("min")).line()
        for n, c in res["checks"].items()]
    # the earlier line: groups, launches and the route taken
    info = json.loads(proc.stdout.strip().splitlines()[-2]
                      [len("portbench: "):])
    assert "launches" in info and "host_codec_calls" in info


@pytest.mark.parametrize("cell", ["seal_1gib_volumes", tiny.READ_CELL])
def test_traced_run_reports_per_layer_metrics_and_a_breakdown(cell,
                                                              tmp_path):
    root = tiny.root_for(cell, tmp_path)
    res = _last_line(tiny.run_cli(cell, trace=1, root=root))
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in harness.cell_metrics(
        harness.load_benchmark(root), cell, True)}
    # the CPU has no device trace: only host and program readings remain
    assert set(res["metrics"]) <= names and res["metrics"]


def test_no_run_holds_jax_or_the_jax_package_by_whole_top_level_name(
        tmp_path):
    for cell in ("seal_backlog_30mib", tiny.READ_CELL):
        proc = tiny.run_cli(cell, trace=1, root=tiny.root_for(cell, tmp_path))
        _last_line(proc)
        mods = _modules(proc)
        assert "seaweedfs_tpu_torch" in mods
        assert not mods & set(harness.FORBIDDEN), mods & set(
            harness.FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "seaweedfs_tpu_torchlike", sys)
    assert "seaweedfs_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "seaweedfs_tpu.ops", sys)
    assert "seaweedfs_tpu" in harness.forbidden_modules()


def test_without_a_card_the_command_exits_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "seal_backlog_30mib", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=tiny.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == harness.EXIT_NO_CARD
    assert proc.stdout == ""


def test_with_only_the_benchmark_files_the_command_fails(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "seal_backlog_30mib", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_the_source_stops_at_the_deadline_and_counts_what_it_fed():
    pool = ["a", "b", "c"]
    fed = [0]
    got = []
    deadline = time.perf_counter() + 0.05
    for i, vol in seal.volumes(pool, deadline=deadline, fed=fed):
        got.append(vol)
        time.sleep(0.01)
    assert time.perf_counter() >= deadline
    assert 3 <= len(got) <= 6 and fed[0] == len(got)
    assert got[:4] == ["a", "b", "c", "a"][:len(got[:4])]
    assert list(seal.volumes(pool, n=4)) == [(0, "a"), (1, "b"),
                                             (2, "c"), (3, "a")]


def test_the_window_byte_count_equals_the_sink_count():
    size = tiny.overrides("seal_backlog_30mib")
    with tiny.small_batches():
        result, outcome = harness.run(
            "seal_backlog_30mib", 11, 0.2, False, time.perf_counter(),
            device="cpu", overrides=size)
    r, cfg = outcome.readings, size["config"]
    volumes = outcome.info["volumes"]
    assert volumes >= 1 and r["dat_bytes"] == volumes * cfg["volume_bytes"]
    from portbench import reference
    lay = reference.Layout(10, 2 ** 30, cfg["scheme"]["small_block_bytes"],
                           cfg["volume_bytes"])
    assert r["sink_bytes"] == volumes * 14 * lay.shard_size
    assert result["checks"]["bytes_wrong"]["value"] == 0
