"""Finds the benchmark's pieces by name, so that a configuration, a traffic
mix, a cell's limits or a per-layer metric is added by adding a file:

  BENCHMARK.json                   the cells, the metrics and their bounds
  meshbench/configs/<config>.json  a configuration as it is run
  meshbench/traffic/<mix>.json     a traffic mix: the driver that runs it
                                   (meshbench/drivers/<driver>.py) and its
                                   parameters
  meshbench/limits/<cell>.json     the limits of the cell's correctness check
  meshbench/metrics/<metric>.py    the reader of one per-layer metric, a
                                   function read(ctx) -> float | None; a
                                   metric "base.qualifier" that has no file
                                   of its own reads with base's (the cells
                                   of one base differ in the end-to-end
                                   metric they move, not in the reading)
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)


class Registry:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.package_dir = os.path.join(root, "meshbench")
        with open(os.path.join(root, "BENCHMARK.json")) as fp:
            self.bench = json.load(fp)

    def _json(self, *parts) -> dict:
        path = os.path.join(self.package_dir, *parts)
        with open(path) as fp:
            return json.load(fp)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as fp:
                    return json.load(fp)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, workload: str) -> dict:
        return self._json("limits", f"{workload}.json")

    def driver(self, name: str):
        return importlib.import_module(f"meshbench.drivers.{name}")

    def metric_reader(self, name: str):
        parts = name.split(".")
        for n in range(len(parts), 0, -1):
            found = ".".join(parts[:n])
            path = os.path.join(self.package_dir, "metrics", f"{found}.py")
            if os.path.exists(path):
                break
        else:
            raise KeyError(f"no reader of metric {name!r} in "
                           f"{self.package_dir}/metrics")
        spec = importlib.util.spec_from_file_location(
            "meshbench_metric_" + found.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def end_to_end(self, workload: str) -> list[dict]:
        """The end-to-end metrics a cell reports: those without a
        ``workloads`` list, and those that list it."""
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        """The per-layer metrics a cell reports: those that list it, and
        those without a list whose ``moves`` metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.bench["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]
