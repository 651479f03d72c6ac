"""Every file a cell is made of loads by name, and a mix added as a file
alone is found."""

import json
import shutil

import pytest

from portbench import harness
from portbench.tests import tiny

BENCH = harness.load_benchmark()
BENCHMARK_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
                 "end_to_end", "per_layer"}


def test_benchmark_json_has_its_keys_and_names_what_exists():
    assert set(BENCH) == BENCHMARK_KEYS
    assert [w["name"] for w in BENCH["workloads"]] == list(tiny.SEAL_CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"seal_gibps", "setup_s"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            # a per-layer metric is read only where its end-to-end one is
            assert any(x["name"] == m["moves"] and w in x.get(
                "workloads", [w]) for x in BENCH["end_to_end"])


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
