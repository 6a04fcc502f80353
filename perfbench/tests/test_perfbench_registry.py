"""Every configuration, cell, mix and metric of BENCHMARK.json is found by
name, and a new one is picked up from its files alone."""
import json
import shutil

import pytest
from perfbench import harness

BENCH = harness.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_agree_with_benchmark(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = harness.workload(cell)
    assert {k: w[k] for k in ("config", "traffic", "chips", "why")} == \
        {k: entry[k] for k in ("config", "traffic", "chips", "why")}
    cfg = harness.config(w["config"])
    assert harness.driver(cfg["driver"]).run
    assert harness.traffic(w["traffic"])["kind"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    cfg = harness.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
    assert set(entry["reduced"]) <= set(cfg)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(harness.metric_reader(metric))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w["name"],
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, w["name"], "per_layer")
        moves = {m["moves"] for m in harness.cell_metrics(
            BENCH, w["name"], "per_layer")}
        assert moves <= e2e


def test_a_new_cell_config_mix_and_metric_are_files_only(tmp_path,
                                                         monkeypatch):
    """A copy of the benchmark's folder, plus new files and nothing
    edited: the harness finds every new piece by its name."""
    root = tmp_path / "perfbench"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = harness.config("kitti-hdl64-pairs")
    cfg = dict(cfg, name="kitti-vlp-pairs",
               scene=dict(cfg["scene"], max_points=30000))
    (root / "configs" / "kitti-vlp-pairs.json").write_text(json.dumps(cfg))
    (root / "traffic" / "mixes" / "pairs-b256.json").write_text(json.dumps(
        dict(harness.traffic("pairs-b128-prior"),
             pairs_per_profile=[26] * 8 + [24] * 2)))
    (root / "workloads" / "pairs-vlp-b256.json").write_text(json.dumps(
        {"config": "kitti-vlp-pairs", "traffic": "pairs-b256", "chips": 1,
         "why": "a new cell"}))
    (root / "metrics" / "probe_share.py").write_text(
        "def read(trace, name):\n    return 42.0\n")
    monkeypatch.setattr(harness, "HERE", root)
    w = harness.workload("pairs-vlp-b256")
    assert harness.config(w["config"])["scene"]["max_points"] == 30000
    assert sum(harness.traffic(w["traffic"])["pairs_per_profile"]) == 256
    assert harness.metric_reader("probe_share.pairs")(None, "x") == 42.0
    assert harness.metric_file("probe_share").name == "probe_share.py"
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "probe_share.pairs", "workloads": ["pairs-vlp-b256"]}])
    assert [m["name"] for m in harness.cell_metrics(
        bench, "pairs-vlp-b256", "per_layer")] == ["probe_share.pairs"]


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        harness.workload("no-such-cell")
    with pytest.raises(KeyError):
        harness.metric_reader("no_such.metric")
    with pytest.raises(KeyError):
        harness.driver("no_such_driver")
