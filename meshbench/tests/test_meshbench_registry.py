"""A configuration, a traffic mix, a cell's limits and a per-layer metric
are added by adding files: the registry finds them by name."""
import json
import os
import shutil
import time

from meshbench.harness import make_cell, run_cell
from meshbench.registry import Registry


def test_new_files_are_found_by_name(root32, tmp_path):
    root = str(tmp_path / "copy")
    shutil.copytree(root32, root)
    pkg = os.path.join(root, "meshbench")
    with open(os.path.join(pkg, "configs", "grid.json")) as fp:
        config = json.load(fp)
    config["name"] = "grid_k2"
    config["program"]["polygon_order"] = [2, 2, 2, 2, 2]
    with open(os.path.join(pkg, "configs", "grid_k2.json"), "w") as fp:
        json.dump(config, fp)
    with open(os.path.join(pkg, "traffic", "grid_train.json")) as fp:
        mix = json.load(fp)
    mix["train_meshes"] = 8
    with open(os.path.join(pkg, "traffic", "short_epochs.json"), "w") as fp:
        json.dump(mix, fp)
    shutil.copy(os.path.join(pkg, "limits", "grid.train.json"),
                os.path.join(pkg, "limits", "grid_k2.short.json"))
    with open(os.path.join(pkg, "metrics", "steps_seen.train.py"),
              "w") as fp:
        fp.write('def read(ctx):\n    return float(ctx["queued_steps"])\n')
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    bench["configs"].append({"name": "grid_k2", "source": "test",
                             "file": "meshbench/configs/grid_k2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "grid_k2.short", "config": "grid_k2",
                               "traffic": "short_epochs", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({
        "name": "train_meshes_per_s.grid_k2", "unit": "meshes/s",
        "better": "higher", "bound": 0.25, "source": "host_clock",
        "workloads": ["grid_k2.short"]})
    bench["per_layer"].append({
        "name": "steps_seen.train", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train loop",
        "moves": "train_meshes_per_s.grid_k2",
        "workloads": ["grid_k2.short"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fp:
        json.dump(bench, fp)

    reg = Registry(root)
    assert reg.config("grid_k2")["program"]["polygon_order"][0] == 2
    assert reg.traffic("short_epochs")["train_meshes"] == 8
    assert reg.limits("grid_k2.short") == reg.limits("grid.train")
    assert [m["name"] for m in reg.per_layer("grid_k2.short")] == [
        "steps_seen.train"]
    assert reg.metric_reader("steps_seen.train")({"queued_steps": 3}) == 3.0
    assert "steps_seen.train" not in [m["name"] for m in
                                      reg.per_layer("grid.train")]
    cell = make_cell(reg, "grid_k2.short", 5, 0.3, False, "cpu",
                     time.perf_counter())
    result, _ = run_cell(reg, cell)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s",
                                      "train_meshes_per_s.grid_k2"}
    assert result["metrics"]["train_meshes_per_s.grid_k2"]["value"] > 0


def test_every_cell_of_the_benchmark_has_its_files():
    reg = Registry()
    for w in reg.bench["workloads"]:
        assert reg.config(w["config"])["name"] == w["config"]
        driver = reg.driver(reg.traffic(w["traffic"])["driver"])
        assert callable(driver.run)
        assert set(reg.limits(w["name"]))
        assert reg.end_to_end(w["name"]) and reg.per_layer(w["name"])
    for m in reg.bench["per_layer"]:
        assert callable(reg.metric_reader(m["name"]))
