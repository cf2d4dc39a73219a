"""Configurations, traffic mixes, drivers, limits and metric readers are
found by the names BENCHMARK.json gives, so a later change adds a cell by
adding files and entries."""

import json
import shutil

from conftest import ROOT

from perfbench import harness


def test_every_named_file_exists_and_loads():
    bench = harness.load_bench(ROOT)
    for cell in bench["workloads"]:
        harness.config_of(ROOT, bench, cell["config"])
        tr = harness.traffic_of(harness.PKG, cell["traffic"])
        assert hasattr(harness.driver_of(harness.PKG, tr), "run")
        assert harness.limits_of(harness.PKG, cell["name"])
        for trace in (False, True):
            assert harness.metrics_for(bench, cell["name"], trace)
    for m in bench["per_layer"]:
        assert callable(harness.reader_of(harness.PKG, m["name"]).read)


def test_a_throwaway_cell_is_found_without_editing_a_file(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench")
    bench = harness.load_bench(ROOT)
    pkg = root / "perfbench"
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    (pkg / "configs" / "tiny-x.json").write_text(json.dumps({"name": "tiny-x", "hidden_size": 8}))
    (pkg / "traffic" / "burst.json").write_text(json.dumps({"driver": "train", "docs": 3}))
    (pkg / "metrics" / "queue_ms.burst.py").write_text("def read(data):\n    return 4.5\n")
    (pkg / "limits" / "tiny-x.burst.json").write_text(json.dumps({"limits": {"loss_gap": 1}}))
    bench["configs"].append({"name": "tiny-x", "source": "https://example.org", "reduced": [],
                             "file": "perfbench/configs/tiny-x.json", "why": "test"})
    bench["workloads"].append({"name": "tiny-x.burst", "config": "tiny-x",
                               "traffic": "burst", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "queue_ms.burst", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "engine",
                               "moves": "setup_s", "workloads": ["tiny-x.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = harness.load_bench(root)
    assert harness.config_of(root, bench, "tiny-x")["hidden_size"] == 8
    tr = harness.traffic_of(pkg, "burst")
    assert harness.driver_of(pkg, tr).__name__ == "perfbench_driver_train"
    assert harness.limits_of(pkg, "tiny-x.burst") == {"loss_gap": 1}
    names = [m["name"] for m in harness.metrics_for(bench, "tiny-x.burst", True)]
    assert names == ["queue_ms.burst"]
    assert harness.reader_of(pkg, "queue_ms.burst").read({}) == 4.5
    for p, data in before.items():
        assert p.read_bytes() == data


def test_metrics_without_a_workloads_key_follow_the_end_to_end_metric_they_move():
    bench = harness.load_bench(ROOT)
    bench["per_layer"].append({"name": "x.all", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "train", "moves": "train_tokens_per_s"})
    assert "x.all" in [m["name"] for m in harness.metrics_for(bench, "minilm-l6-1m.train", True)]
    assert "x.all" not in [m["name"] for m in harness.metrics_for(bench, "other.cell", True)]
    e2e = [m["name"] for m in harness.metrics_for(bench, "minilm-l6-1m.train", False)]
    assert e2e == ["train_tokens_per_s", "setup_s"]
