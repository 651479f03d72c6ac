"""Every file a cell is made of loads by name, BENCHMARK.json keeps the
rules of portbench/tests/rules.py, each rule refuses what it forbids,
and a mix added as a file alone is found."""

import json
import shutil

import pytest

from portbench import harness
from portbench.tests import rules, tiny

BENCH = harness.load_benchmark()
BENCHMARK_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
                 "end_to_end", "per_layer"}


def test_benchmark_json_has_its_keys_and_names_what_exists(tmp_path):
    assert set(BENCH) == BENCHMARK_KEYS
    assert rules.problems(tiny.ROOT) == []
    # and so it does with the read mode's fixture appended
    assert rules.problems(tiny.root_with_read_cell(tmp_path)) == []


def _extra_cell(bench, name="seal_extra"):
    w = dict(bench["workloads"][0], name=name)
    bench["workloads"].append(w)
    return w


#: (id, the rule, a breach of it made in a copy of BENCHMARK.json)
BREACHES = [
    ("name_starts_with_a_dot", rules.names_are_unique_and_valid,
     lambda b: b["configs"][0].update(name=".cold")),
    ("name_too_long", rules.names_are_unique_and_valid,
     lambda b: _extra_cell(b, "s" * 65)),
    ("cell_named_twice", rules.names_are_unique_and_valid,
     lambda b: b["workloads"].append(dict(b["workloads"][0]))),
    ("metric_named_twice", rules.names_are_unique_and_valid,
     lambda b: b["per_layer"].append(dict(b["end_to_end"][0]))),
    ("configuration_not_listed", rules.cells_name_files_that_load,
     lambda b: b["workloads"][0].update(config="no_such_config")),
    ("configuration_file_missing", rules.cells_name_files_that_load,
     lambda b: b["configs"][0].update(file="portbench/configs/no.json")),
    ("mix_file_missing", rules.cells_name_files_that_load,
     lambda b: b["workloads"][0].update(traffic="no_such_mix")),
    ("configuration_serves_no_cell", rules.cells_name_files_that_load,
     lambda b: b["configs"].append(dict(b["configs"][0], name="spare"))),
    ("two_chips", rules.chips_are_one_or_four_and_four_are_few,
     lambda b: b["workloads"][0].update(chips=2)),
    ("too_many_on_four_chips", rules.chips_are_one_or_four_and_four_are_few,
     lambda b: [w.update(chips=4) for w in b["workloads"]]),
    ("metric_without_a_reader",
     rules.metrics_have_readers_that_find_nothing_in_an_empty_run,
     lambda b: b["per_layer"].append(dict(b["per_layer"][0],
                                          name="no_reader.seal"))),
    ("per_layer_where_its_end_to_end_is_not",
     rules.per_layer_metrics_are_read_only_where_their_end_to_end_is,
     lambda b: b["per_layer"][0]["workloads"].append(
         _extra_cell(b)["name"])),
    ("cell_with_no_end_to_end_metric",
     rules.every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric,
     lambda b: _extra_cell(b)),
]


@pytest.mark.parametrize("rule, breach", [b[1:] for b in BREACHES],
                         ids=[b[0] for b in BREACHES])
def test_each_rule_refuses_what_it_forbids(rule, breach, tmp_path):
    bench = json.loads(json.dumps(BENCH))
    breach(bench)
    assert rule(rules.linked_root(tmp_path, bench))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_loads_and_pins_the_card_route(entry):
    cfg = harness.load_config(BENCH, entry["name"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["env"] == {"SEAWEEDFS_TORCH_HOST_DISPATCH": "device"}
    for key in ("scheme", "volume_bytes", "lost_shards", "guarantees",
                "assumed"):
        assert key in cfg


@pytest.mark.parametrize("w", BENCH["workloads"] +
                         tiny.READ_ENTRIES["workloads"],
                         ids=lambda w: w["name"])
def test_each_mix_loads_and_names_a_mode(w):
    traffic = harness.load_traffic(w["traffic"])
    assert callable(harness.load_mode(traffic["mode"]).run)


@pytest.mark.parametrize(
    "name", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
             + tiny.READ_ENTRIES["end_to_end"]
             + tiny.READ_ENTRIES["per_layer"]])
def test_each_metric_has_a_reader_that_finds_nothing_in_an_empty_run(name):
    from portbench import trace
    empty = harness.Outcome(setup_s=1.0, attempted=0, failed=0, checks=[],
                            readings={}, window=trace.Window(False, False))
    value = harness.load_metric(name).read(empty)
    assert value is None or name == "setup_s"


def test_a_mix_added_as_a_file_alone_is_found(tmp_path):
    shutil.copytree(tiny.ROOT / "portbench" / "configs",
                    tmp_path / "portbench" / "configs")
    shutil.copytree(tiny.ROOT / "portbench" / "metrics",
                    tmp_path / "portbench" / "metrics")
    (tmp_path / "portbench" / "traffic").mkdir()
    mix = dict(harness.load_traffic("seal_backlog"), pool_volumes=2)
    (tmp_path / "portbench" / "traffic" / "seal_pool2.json").write_text(
        json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "seal_pool2", "chips": 1,
                               "config": "cold_tier_30mib_rs10_4",
                               "traffic": "seal_pool2", "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("seal_pool2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with tiny.small_batches():
        result, outcome = harness.run(
            "seal_pool2", 5, 0.05, False, 0.0, device="cpu",
            overrides=tiny.overrides("seal_backlog_30mib"), root=tmp_path)
    assert result["correct"], result
    assert set(result["metrics"]) == {"seal_gibps", "setup_s"}
